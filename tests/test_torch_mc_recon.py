"""The PyTorch port's MC stage of the main path (ops.cuda_mc.mc_recon_*),
on the CPU, against the JAX package, exactly (integer codec, zero
tolerance): the plain version against the JAX package's XLA prediction
and combine, and the dense per-block prediction it makes against the
uniform pass plus the exception quads on the port's front-end output.
The kernel itself is held to the plain version on the card
(tests/test_torch_kernels_cuda.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from h264bsd_tpu.ops import inter as jinter
from h264bsd_tpu.ops import reconstruct as jreconstruct
from h264bsd_tpu_torch.frontend import binding as fe
from h264bsd_tpu_torch.models.decoder import Decoder
from h264bsd_tpu_torch.ops import _kernels
from h264bsd_tpu_torch.ops import inter as tinter
from h264bsd_tpu_torch.ops.cuda_mc import (mc_exception_plain,
                                           mc_recon_cuda, mc_recon_plain,
                                           mc_uniform_plain)
from h264bsd_tpu_torch.ops.unpack import (blob_words, unpack_blob,
                                          unpack_meta)
from h264bsd_tpu_torch.utils.kernel_cases import (mc_recon_case,
                                                  mc_recon_inputs,
                                                  mc_recon_kind_cases)
from h264bsd_tpu_torch.utils.motion_stream import make_motion_stream

CPU = torch.device("cpu")


def _eq(got, want, name):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want), name)


def _jax_recon(c, w, h):
    """h264bsd_tpu's inter prediction and combine on the case's numpy
    arrays: inter_predict_frame, then the where/clip/PCM lines and
    mb_grid_to_plane of ops/reconstruct.py (reconstruct_frame :66-82)."""
    pred_y, pred_cb, pred_cr = jinter.inter_predict_frame(
        *(jnp.asarray(c[k]) for k in ("dpb_y", "dpb_cb", "dpb_cr")),
        jnp.asarray(c["mv"].astype(np.int32)),
        jnp.asarray(c["ref_slot"].astype(np.int32)), w, h)
    mb_class = jnp.asarray(c["mb_class"].astype(np.int32))
    res_l = jnp.asarray(c["res_l"])
    res_c = jnp.asarray(c["res_c"])
    inter_mask = (mb_class == 1) | (mb_class == 2)
    pcm_mask = mb_class == 5
    mb_y = jnp.where(inter_mask[:, None, None],
                     jnp.clip(pred_y + res_l, 0, 255), 0).astype(jnp.uint8)
    mb_cb = jnp.where(inter_mask[:, None, None],
                      jnp.clip(pred_cb + res_c[:, 0], 0, 255), 0)
    mb_cr = jnp.where(inter_mask[:, None, None],
                      jnp.clip(pred_cr + res_c[:, 1], 0, 255), 0)
    if "pcm_y" in c:
        mb_y = jnp.where(pcm_mask[:, None, None], c["pcm_y"], mb_y)
        mb_cb = jnp.where(pcm_mask[:, None, None], c["pcm_cb"], mb_cb)
        mb_cr = jnp.where(pcm_mask[:, None, None], c["pcm_cr"], mb_cr)
    return (jreconstruct.mb_grid_to_plane(mb_y, w, h),
            jreconstruct.mb_grid_to_plane(mb_cb.astype(jnp.uint8), w, h),
            jreconstruct.mb_grid_to_plane(mb_cr.astype(jnp.uint8), w, h))


# (seed, dims, slots, PCM grids): the decode tests' size and a mid size,
# 1, 4 and 16 reference slots, with and without I_PCM MBs
JAX_CASES = [(0, (6, 4), 1, False), (1, (20, 12), 4, True),
             (2, (6, 4), 16, True)]


@pytest.mark.parametrize("seed,dims,n_slots,pcm", JAX_CASES)
def test_mc_recon_plain_matches_jax_combine(seed, dims, n_slots, pcm):
    c = mc_recon_case(seed, *dims, n_slots, 0.25, pcm=pcm)
    args = mc_recon_inputs(c, CPU)
    got = mc_recon_plain(*args, *dims)
    want = _jax_recon(c, *dims)
    for g, w, name in zip(got, want, ("y", "cb", "cr")):
        assert g.dtype == torch.uint8 and g.is_contiguous()
        _eq(g, w, name)
    # the wrapper on CPU tensors is the plain version, and launches nothing
    before = dict(_kernels.LAUNCHES)
    for g, w in zip(mc_recon_cuda(*args, *dims), got):
        assert torch.equal(g, w)
    assert _kernels.LAUNCHES == before


@pytest.mark.parametrize("motion", ["mixed", "edge", "integer"])
def test_mc_recon_case_covers_every_path(motion):
    """The kernel's cases reach every branch of mc_recon_kernel: each MB
    class, PCM MBs, uniform and split inter MBs, residuals that clip on
    both sides; "edge" puts every uniform MB's and every split block's
    luma window across a frame edge, "integer" only whole-pel MVs."""
    w, h = 6, 4
    n = w * h
    W = 16 * w
    c = mc_recon_case(3, w, h, 4, 0.25, pcm=True, motion=motion)
    cls = c["mb_class"]
    assert set(cls.tolist()) >= {1, 2, 5}
    assert set(cls.tolist()) & {3, 4}
    assert (cls[c["ref_slot"][:, 0] == -1] >= 3).all()
    mv = c["mv"].astype(np.int64)
    uniform = ((mv == mv[:, :1]).all((1, 2))
               & (c["ref_slot"] == c["ref_slot"][:, :1]).all(1))
    inter = (cls == 1) | (cls == 2)
    assert (inter & uniform).any() and (inter & ~uniform).any()
    for res, lo, hi in ((c["res_l"], -300, 300), (c["res_c"], -300, 300)):
        assert res.dtype == np.int32
        assert res.min() == lo and res.max() == hi
        assert 0.5 < (res == 0).mean() < 0.9
    x, y = mv[..., 0], mv[..., 1]
    if motion == "integer":
        assert ((x & 3) == 0).all() and ((y & 3) == 0).all()
        assert ((x & 7) == 4).any() and ((x & 7) == 0).any()
    else:
        assert len(set(((x & 3) * 4 + (y & 3)).ravel())) == 16
    if motion == "edge":
        col = np.arange(n) % w * 16
        xi = col + (x[:, 0] >> 2)
        assert ((xi - 2 < 0) | (xi + 19 > W))[uniform].all()
        bx = col[:, None] + tinter.BLOCK_X[None, :] + (x >> 2)
        assert ((bx - 2 < 0) | (bx + 7 > W))[~uniform].all()


def test_mc_recon_kind_cases_take_one_path():
    """The frames chip_smoke.py times mc_recon on, one path each: all MBs
    intra; all inter and uniform with whole-pel MVs; all inter and
    uniform; all inter and split; all inter with every window across a
    frame edge."""
    w, h = 6, 4
    cases = dict(mc_recon_kind_cases(w, h))
    assert len(cases) == 5
    for label, c in cases.items():
        cls = c["mb_class"]
        mv = c["mv"].astype(np.int64)
        uniform = ((mv == mv[:, :1]).all((1, 2))
                   & (c["ref_slot"] == c["ref_slot"][:, :1]).all(1))
        whole = ((mv & 3) == 0).all((1, 2))
        assert (cls == (3 if label == "all intra" else 2)).all(), label
        if label == "all inter, whole-pel MVs":
            assert uniform.all() and whole.all()
        elif label == "all inter, uniform":
            assert uniform.all() and not whole.all()
        elif label == "all inter, split":
            assert not uniform.any()
        elif label == "all inter, edge windows":
            xi = np.arange(w * h) % w * 16 + (mv[:, 0, 0] >> 2)
            assert ((xi - 2 < 0) | (xi + 19 > 16 * w))[uniform].all()


def _pictures_motion(data):
    """Per picture of the stream: the port's unpack_meta tensors and its
    blob's exception ids, through the port's front-end."""
    dec = Decoder(device="cpu")
    frames = []
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
            frames.append((prep["w_mbs"], prep["h_mbs"], t, eids))
            while dec._fe.next_output() is not None:
                pass
        elif status >= fe.ERROR and read == 0:
            break
    return frames


# the decode tests' motion stream, and one whose P pictures reference up
# to six slots
STREAMS = {
    "motion": lambda: make_motion_stream(6, 4, 4, seed=0),
    "motion_six_refs": lambda: make_motion_stream(6, 4, 8, seed=3,
                                                  num_ref_frames=6),
}


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_dense_prediction_equals_uniform_plus_exceptions(name):
    """On every picture the front-end ships, predicting each 4x4 block
    from unpack_meta's dense motion (what mc_recon does) gives the bytes
    of the uniform pass with block 0's motion followed by the listed
    exception quads (what mc_predict_grids does), on every MB: a quad is
    listed exactly when one of its blocks differs from block 0."""
    frames = _pictures_motion(STREAMS[name]())
    assert len(frames) > 1
    rng = np.random.default_rng(0)
    n_exc_total = 0
    slots = set()
    for k, (w, h, t, eids) in enumerate(frames):
        ring = [torch.from_numpy(rng.integers(0, 256, (16, s * h, s * w),
                                              dtype=np.uint8))
                for s in (16, 8, 8)]
        mv, ref = t["mv"], t["ref_slot"]
        dense = tinter.inter_predict_frame(*ring, mv, ref, w, h)
        grids = mc_uniform_plain(*ring, mv, ref, w, h)
        split = mc_exception_plain(*grids, *ring, mv, ref, eids, w, h)
        for d, s, plane in zip(dense, split, ("y", "cb", "cr")):
            assert torch.equal(d.to(torch.uint8), s), f"picture {k} {plane}"
        n_exc_total += int((eids < w * h * 4).sum())
        slots |= set(ref.reshape(-1).tolist())
    assert n_exc_total > 0
    assert len(slots - {-1}) >= 2
