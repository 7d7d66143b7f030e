"""The PyTorch port's motion compensation, on the CPU, against the JAX
package, exactly (integer codec, zero tolerance): ops/inter.py against
the XLA formulation, the MC kernels' wrapper (mc_predict_grids, plain
versions on the CPU) against the Pallas kernels in interpret mode, the
two plain versions against inter_predict_frame, and the motion stream
that drives MC in the decode tests."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from h264bsd_tpu.ops import inter as jinter
from h264bsd_tpu.ops import pallas_mc
from h264bsd_tpu_torch.frontend import binding as fe
from h264bsd_tpu_torch.models.decoder import Decoder
from h264bsd_tpu_torch.models.state import from_numpy
from h264bsd_tpu_torch.ops import inter as tinter
from h264bsd_tpu_torch.ops.cuda_mc import (mc_exception_plain,
                                           mc_predict_grids,
                                           mc_uniform_plain)
from h264bsd_tpu_torch.ops.unpack import (blob_words, unpack_blob,
                                          unpack_meta)
from h264bsd_tpu_torch.utils.kernel_cases import mc_case, mc_inputs
from h264bsd_tpu_torch.utils.motion_stream import make_motion_stream

CPU = torch.device("cpu")


def _eq(got, want, name):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want), name)


@pytest.mark.parametrize("seed", [0, 1])
def test_inter_predict_frame_matches_jax(seed):
    """6x4 MBs, 3 slots, MVs within +-80 quarter pels and far outside the
    frame, exception MBs with per-block motion, slot -1 MBs."""
    c = mc_case(seed, 6, 4, 3, 0.25)
    want = jinter.inter_predict_frame(
        *(jnp.asarray(c[k]) for k in ("dpb_y", "dpb_cb", "dpb_cr")),
        jnp.asarray(c["mv"].astype(np.int32)),
        jnp.asarray(c["ref_slot"].astype(np.int32)), 6, 4)
    got = tinter.inter_predict_frame(*mc_inputs(c, CPU)[:5], 6, 4)
    for g, w, name in zip(got, want, ("y", "cb", "cr")):
        assert g.dtype == torch.int32
        _eq(g, w, name)


def _pallas_case(seed, w_mbs, h_mbs, n_slots, mv_range, exc, used, draw_ref):
    """The inputs of tests/test_pallas_mc.py's cases, drawn in its order."""
    rng = np.random.default_rng(seed)
    n_mb = w_mbs * h_mbs
    H, W = h_mbs * 16, w_mbs * 16
    ring = [rng.integers(0, 255, (n_slots, H, W), dtype=np.uint8),
            rng.integers(0, 255, (n_slots, H // 2, W // 2), dtype=np.uint8),
            rng.integers(0, 255, (n_slots, H // 2, W // 2), dtype=np.uint8)]
    mv = np.zeros((n_mb, 16, 2), np.int32)
    mv[:] = rng.integers(-mv_range, mv_range, (n_mb, 1, 2))
    mv[exc] = rng.integers(-mv_range, mv_range, (len(exc), 16, 2))
    ref_slot = np.zeros((n_mb, 16), np.int32)
    draw_ref(rng, ref_slot)
    exc_ids = np.full(16, n_mb * 4, np.int32)
    exc_ids[:4 * len(exc)] = (exc[:, None] * 4 +
                              np.arange(4)[None, :]).reshape(-1)
    return ring, mv, ref_slot, exc_ids, np.asarray(used, np.int32)


def _single_group_refs(exc):
    def draw(rng, ref_slot):
        ref_slot[:] = rng.integers(0, 2, (ref_slot.shape[0], 1)) * 2
        ref_slot[exc] = rng.integers(0, 2, (len(exc), 16)) * 2
    return draw


def _multi_group_refs(exc, used):
    def draw(rng, ref_slot):
        ref_slot[:] = used[rng.integers(0, 6, (ref_slot.shape[0], 1))]
        ref_slot[exc] = used[rng.integers(0, 6, (len(exc), 16))]
    return draw


_USED8 = np.array([0, 2, 3, 5, 6, 7, 0, 0], np.int32)
PALLAS_CASES = {
    # test_pallas_mc.py:14-58 (seed 0): slots {0, 2}, one VMEM group
    "single_group": (0, 6, 4, 3, 80, np.array([1, 5, 17], np.int32),
                     [0, 2], _single_group_refs(np.array([1, 5, 17]))),
    # :61-104: six of 8 slots, two VMEM groups merged per block
    "multi_group": (7, 5, 3, 8, 40, np.array([2, 9], np.int32), _USED8,
                    _multi_group_refs(np.array([2, 9]), _USED8)),
}


@pytest.mark.parametrize("name", sorted(PALLAS_CASES))
def test_mc_predict_grids_matches_pallas_interpret(name):
    """Every MB of these cases is inter with its slots listed in
    used_slots, where the Pallas path and ops.inter agree (Pallas maps an
    unlisted slot to used_slots[0], pallas_mc.py:363)."""
    seed, w, h, n_slots, rng_mv, exc, used, draw = PALLAS_CASES[name]
    ring, mv, ref_slot, exc_ids, used = _pallas_case(
        seed, w, h, n_slots, rng_mv, exc, used, draw)
    want = pallas_mc.mc_predict_grids(
        *(jnp.asarray(p) for p in ring), jnp.asarray(mv),
        jnp.asarray(ref_slot), jnp.asarray(exc_ids), jnp.asarray(used), w,
        h, interpret=True)
    t = from_numpy(dict(y=ring[0], cb=ring[1], cr=ring[2], mv=mv,
                        ref_slot=ref_slot, exc_ids=exc_ids), CPU)
    got = mc_predict_grids(t["y"], t["cb"], t["cr"], t["mv"], t["ref_slot"],
                           t["exc_ids"], w, h, n_exc=4 * len(exc))
    for g, wnt, plane in zip(got, want, ("y", "cb", "cr")):
        assert g.dtype == torch.uint8
        _eq(g, wnt, plane)


@pytest.mark.parametrize("seed,dims,n_slots,share", [
    (0, (6, 4), 3, 0.25), (1, (5, 3), 16, 0.5), (2, (4, 4), 1, 0.0)])
def test_uniform_then_exception_equals_inter_predict_frame(seed, dims,
                                                           n_slots, share):
    """The two plain versions in turn (uniform, then the listed quads over
    it) give inter_predict_frame's prediction of every MB: the quads not
    listed repeat block 0's motion, and slot -1 MBs read slot 0 in
    both."""
    c = mc_case(seed, *dims, n_slots, share)
    dpb_y, dpb_cb, dpb_cr, mv, ref_slot, exc_ids = mc_inputs(c, CPU)
    want = tinter.inter_predict_frame(dpb_y, dpb_cb, dpb_cr, mv, ref_slot,
                                      *dims)
    grids = mc_uniform_plain(dpb_y, dpb_cb, dpb_cr, mv, ref_slot, *dims)
    got = mc_exception_plain(*grids, dpb_y, dpb_cb, dpb_cr, mv, ref_slot,
                             exc_ids, *dims, n_exc=c["n_exc"])
    for g, w, name in zip(got, want, ("y", "cb", "cr")):
        _eq(g, w.to(torch.uint8), name)
    # the wrapper on CPU tensors is the same two plain versions
    for g, w in zip(mc_predict_grids(*mc_inputs(c, CPU), *dims), got):
        assert torch.equal(g, w)


def test_mc_case_covers_every_case():
    """The kernel case covers all 16 luma fractional codes, all 64 chroma
    weights, up to 16 slots, MVs outside the frame on every side up to
    the front-end's limits, and padded exception ids."""
    c = mc_case(0, 6, 4, 16, 0.25)
    mv = c["mv"].astype(np.int64)
    x, y = mv[..., 0], mv[..., 1]
    assert len(set(((x & 3) * 4 + (y & 3)).ravel())) == 16
    assert len(set(((x & 7) * 8 + (y & 7)).ravel())) == 64
    assert x.min() < -8000 and x.max() > 8000
    assert y.min() < -2000 and y.max() > 2000
    assert (x >= -8192).all() and (x <= 8191).all()
    assert (y >= -2048).all() and (y <= 2047).all()
    n = 24
    ids = c["exc_ids"]
    assert (ids[:c["n_exc"]] < n * 4).all() and (ids[c["n_exc"]:] >= n * 4
                                                  ).all()
    assert len(ids) > c["n_exc"] > 0
    assert (c["ref_slot"] == -1).any()


def _motion_frames(data):
    """Per picture: pic_info, the real exception count (the ids that are
    not padding) and the unpacked MB tensors, read through the port's
    front-end and unpack_meta."""
    dec = Decoder(device="cpu")
    frames = []
    errs = []
    pos = 0
    while pos < len(data):
        status, read = dec._fe.decode(data, 0, pos)
        pos += read
        if status == fe.PIC_RDY:
            prep = dec._prepare()
            n = prep["n_mbs"]
            (packed, stab, sids, _, eids, epay, iids, ipay,
             slice_ids) = unpack_blob(blob_words(prep["blob"], CPU), n,
                                      *prep["caps"])
            t = unpack_meta(packed, stab, eids, epay, iids, ipay, n,
                            slice_ids, sparse_ids=sids)
            frames.append((prep["info"], int((eids < n * 4).sum()), t))
            while (o := dec._fe.next_output()) is not None:
                errs.append(o["num_err_mbs"])
        elif status >= fe.ERROR and read == 0:
            break
    dec.flush_buffer()
    while (o := dec._fe.next_output()) is not None:
        errs.append(o["num_err_mbs"])
    return frames, errs


def test_motion_stream_exercises_motion_compensation():
    """make_motion_stream(6, 4, 4, seed=0): decodes without error; every
    P picture has exception quads; the stream references >= 2 slots, all
    16 luma fractional codes and MVs whose blocks' windows leave the
    frame, and has P_Skip MBs with a (predicted) non-zero MV."""
    frames, errs = _motion_frames(make_motion_stream(6, 4, 4, seed=0))
    assert errs == [0, 0, 0, 0]
    assert [f[0]["slice_type"] for f in frames] == [7, 5, 5, 5]
    slots, fracs, outside, skip_moves = set(), set(), False, False
    H, W = 64, 96
    for info, n_exc, t in frames[1:]:
        assert info["num_concealed_mbs"] == 0
        assert n_exc > 0
        cls = t["mb_class"].numpy()
        mv = t["mv"].long().numpy()
        ref = t["ref_slot"].numpy()
        inter = (cls == 1) | (cls == 2)
        skip_moves |= bool(np.abs(mv[cls == 1]).sum() > 0)
        slots |= set(ref[inter].ravel().tolist())
        x, y = mv[inter][..., 0], mv[inter][..., 1]
        fracs |= set(((x & 3) * 4 + (y & 3)).ravel().tolist())
        mb = np.flatnonzero(inter)
        bx = (mb % 6 * 16)[:, None] + tinter.BLOCK_X[None, :] + (x >> 2)
        by = (mb // 6 * 16)[:, None] + tinter.BLOCK_Y[None, :] + (y >> 2)
        outside |= bool(((bx < 0) | (bx > W - 4) | (by < 0)
                         | (by > H - 4)).any())
    assert len(slots) >= 2
    assert len(fracs) == 16
    assert outside
    assert skip_moves
