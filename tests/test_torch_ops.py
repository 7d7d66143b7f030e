"""The PyTorch port's ops (plain versions, on the CPU) against the JAX
package's XLA paths, exactly (integer codec, zero tolerance). The same
numpy inputs go to both packages; the port takes them through
models.state.from_numpy."""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from h264bsd_tpu.ops import deblock as jdeblock
from h264bsd_tpu.ops import intra as jintra
from h264bsd_tpu.ops import reconstruct as jreconstruct
from h264bsd_tpu.ops import transform as jtransform
from h264bsd_tpu.ops import unpack as junpack
from h264bsd_tpu.utils import streamgen
from h264bsd_tpu_torch.frontend import binding as fe
from h264bsd_tpu_torch.models.decoder import WF_THRESH, caps_from_counts
from h264bsd_tpu_torch.models.state import from_numpy, tensor_from_numpy
from h264bsd_tpu_torch.ops import _kernels
from h264bsd_tpu_torch.ops import deblock as tdeblock
from h264bsd_tpu_torch.ops import intra as tintra
from h264bsd_tpu_torch.ops import reconstruct as treconstruct
from h264bsd_tpu_torch.ops import transform as ttransform
from h264bsd_tpu_torch.ops import unpack as tunpack
from h264bsd_tpu_torch.ops.cuda_deblock_wf import deblock_frame_wavefront
from h264bsd_tpu_torch.ops.cuda_intra import intra_pass_cuda
from h264bsd_tpu_torch.ops.cuda_intra_wf import intra_pass_wavefront_cuda
from h264bsd_tpu_torch.utils.kernel_cases import (DEBLOCK_STATE,
                                                  INTRA_STATE, deblock_case,
                                                  intra_case,
                                                  padded_intra_ids)

CPU = torch.device("cpu")
THRESH_STATE = ("qp_y", "slice_id", "filter_off_a", "filter_off_b",
                "chroma_qp_offset")


def _eq(got, want, name):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want), name)


# ---------------------------------------------------------------------------
# unpack + sparse transform on real front-end blobs
# ---------------------------------------------------------------------------

def _blobs(data):
    """(blob u8, n_mbs, caps) of every picture of the stream."""
    dec = fe.FrontendDecoder()
    out = []
    pos = 0
    while pos < len(data):
        status, read = dec.decode(data, 0, pos)
        pos += read
        if status == fe.PIC_RDY:
            g = dec.stream_info()
            n = g["width_mbs"] * g["height_mbs"]
            counts = [int(x) for x in dec.blob_counts()]
            caps = caps_from_counts(counts, n, counts[5] > WF_THRESH)
            words = tunpack.compact_blob_words(counts, n, caps)[1]
            out.append((dec.blob_compact(*caps, words * 4), n, caps))
            while dec.next_output() is not None:
                pass
        elif status >= fe.ERROR and read == 0:
            break
    dec.close()
    return out


@partial(jax.jit, static_argnums=(1, 2))
def _jax_unpack_transform(blob, n, caps):
    parts = junpack.unpack_blob(blob, n, *caps)
    (packed, stab, sids, slv, eids, epay, iids, ipay, slice_ids) = parts
    t = junpack.unpack_meta(packed, stab, eids, epay, iids, ipay, n,
                            slice_ids, sparse_ids=sids)
    res = jtransform.residual_planes_sparse(
        sids.reshape(-1).astype(jnp.int32), slv.astype(jnp.int32),
        t["qp_y"].astype(jnp.int32), t["chroma_qp_offset"].astype(jnp.int32),
        t["nnz_dc"].astype(jnp.int32), t["mb_class"] == 4, n)
    return parts, t, res


@pytest.mark.parametrize("maker,args", [
    ("make_qp_sweep_stream", ()), ("make_lowqp_i_stream", ()),
    ("make_intra_stress_stream", (4, 4, 2))])
def test_unpack_and_transform_match_jax(maker, args):
    blobs = _blobs(getattr(streamgen, maker)(*args))
    assert blobs
    for blob, n, caps in blobs:
        (jparts, jt, (jres_l, jres_c)) = _jax_unpack_transform(
            jnp.asarray(blob), n, caps)
        words = tunpack.blob_words(blob, CPU)
        parts = tunpack.unpack_blob(words, n, *caps)
        names = ["packed", "slice_table", "sparse_ids", "sparse_levels",
                 "exc_ids", "exc_payload", "intra_ids", "intra_payload"]
        for name, got, want in zip(names, parts, jparts):
            _eq(got, want, name)
        assert parts[8] is None and jparts[8] is None   # one slice
        (packed, stab, sids, slv, eids, epay, iids, ipay, slice_ids) = parts
        t = tunpack.unpack_meta(packed, stab, eids, epay, iids, ipay, n,
                                slice_ids, sparse_ids=sids)
        assert set(t) == set(jt)
        for k in jt:
            _eq(t[k], jt[k], k)
        res_l, res_c = ttransform.residual_planes_sparse(
            sids.reshape(-1), slv, t["qp_y"], t["chroma_qp_offset"],
            t["nnz_dc"], t["mb_class"] == 4, n)
        _eq(res_l, jres_l, "res_l")
        _eq(res_c, jres_c, "res_c")


# ---------------------------------------------------------------------------
# deblocking
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,dims", [(0, (6, 4)), (2, (3, 7)),
                                       (4, (2, 5)), (5, (1, 1))])
def test_deblock_matches_jax(seed, dims):
    w, h = dims
    case = deblock_case(seed, w, h)
    jargs = [jnp.asarray(case[k]) for k in ("y", "cb", "cr")] + \
        [jnp.asarray(case[k]) for k in DEBLOCK_STATE]
    t = from_numpy(case, CPU)
    state = [t[k] for k in DEBLOCK_STATE]

    jbs = jdeblock.boundary_strengths(
        *(jnp.asarray(case[k]).astype(jnp.int32) for k in DEBLOCK_STATE[:6]),
        w, h)
    bs = tdeblock.boundary_strengths(*state[:6], w, h)
    _eq(bs[0], jbs[0], "bs_left")
    _eq(bs[1], jbs[1], "bs_top")
    for chroma in (False, True):
        jthr = jdeblock.edge_thresholds(
            *(jnp.asarray(case[k]) for k in THRESH_STATE), w, h, chroma)
        thr = tdeblock.edge_thresholds(*(t[k] for k in THRESH_STATE), w, h,
                                       chroma)
        for name, got, want in zip(("alpha", "beta", "tc0"), thr, jthr):
            _eq(got, want, f"{name} chroma={chroma}")

    want = jdeblock.deblock_frame(*jargs, w, h)
    before = dict(_kernels.LAUNCHES)
    # the raster plain version, and the wrapper (wavefront plain version,
    # or the raster hand-off under 3 MBs wide) on CPU tensors
    for fn in (tdeblock.deblock_frame, deblock_frame_wavefront):
        planes = [t[k].clone() for k in ("y", "cb", "cr")]
        got = fn(*planes, *state, w, h)
        for g, wnt, name in zip(got, want, ("y", "cb", "cr")):
            _eq(g, wnt, f"{fn.__name__} {name}")
    assert _kernels.LAUNCHES == before     # CPU tensors: plain versions


# ---------------------------------------------------------------------------
# intra
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dims", [(6, 4), (3, 2)])
def test_intra_matches_jax(dims):
    w, h = dims
    case = intra_case(0, w, h)
    want = jintra.intra_pass(*(jnp.asarray(case[k]) for k in
                               ("y", "cb", "cr") + INTRA_STATE), w)
    t = from_numpy(case, CPU)
    state = [t[k] for k in INTRA_STATE]

    def planes():
        return [t[k].clone() for k in ("y", "cb", "cr")]

    ids = padded_intra_ids(case, 5, CPU)
    before = dict(_kernels.LAUNCHES)
    results = {
        "intra_pass": tintra.intra_pass(*planes(), *state, w),
        "intra_pass_list": tintra.intra_pass_list(*planes(), ids, *state, w),
        "list wrapper": intra_pass_cuda(*planes(), *state, w, h,
                                        intra_ids=ids),
        "wavefront wrapper": intra_pass_wavefront_cuda(*planes(), *state,
                                                       w, h),
    }
    for label, got in results.items():
        for g, wnt, name in zip(got, want, ("y", "cb", "cr")):
            _eq(g, wnt, f"{label} {name}")
    assert _kernels.LAUNCHES == before     # CPU tensors: plain versions


@pytest.mark.parametrize("size,dims", [(16, (5, 3)), (8, (2, 4))])
def test_mb_grid_layout_matches_jax(size, dims):
    w, h = dims
    mbs = np.random.default_rng(size).integers(
        0, 256, (w * h, size, size), dtype=np.uint8)
    want = jreconstruct.mb_grid_to_plane(jnp.asarray(mbs), w, h)
    plane = treconstruct.mb_grid_to_plane(torch.from_numpy(mbs), w, h)
    _eq(plane, want, "plane")
    _eq(treconstruct.plane_to_mb_grid(plane, size),
        jreconstruct.plane_to_mb_grid(want, size), "grid")
    _eq(treconstruct.plane_to_mb_grid(plane, size), mbs, "round trip")


# ---------------------------------------------------------------------------
# constant tables: the port's copies equal the JAX package's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,port,jax_table", [
    ("LEVEL_SCALE", ttransform.LEVEL_SCALE, jtransform.LEVEL_SCALE),
    ("SCALE_IDX", ttransform.SCALE_IDX, jtransform.SCALE_IDX),
    ("QP_C", ttransform.QP_C, jtransform.QP_C),
    ("ALPHAS", tdeblock.ALPHAS, jdeblock.ALPHAS),
    ("BETAS", tdeblock.BETAS, jdeblock.BETAS),
    ("TC0", tdeblock.TC0, jdeblock.TC0),
    ("ZIG2RAS", tintra.ZIG2RAS, jintra.ZIG2RAS),
    ("BLOCK_X", tintra.BLOCK_X, jintra.BLOCK_X),
    ("BLOCK_Y", tintra.BLOCK_Y, jintra.BLOCK_Y),
    ("QUAD_PERM", tunpack.QUAD_PERM, junpack.QUAD_PERM)])
def test_tables_equal(name, port, jax_table):
    assert port.shape == jax_table.shape, name
    assert (port == jax_table).all(), name


def test_from_numpy_dtypes():
    arrays = {"u8": np.array([1, 255], np.uint8),
              "i8": np.array([-1, 7], np.int8),
              "i16": np.array([-300, 5], np.int16),
              "u16": np.array([65535, 1], np.uint16),
              "u32": np.array([0xFFFFFFFF, 3], np.uint32)}
    t = from_numpy(arrays, CPU)
    assert t["u8"].dtype == torch.uint8
    assert t["i8"].dtype == torch.int8
    assert t["i16"].dtype == torch.int16
    assert t["u16"].dtype == torch.int32
    assert t["u32"].dtype == torch.int64
    for k, a in arrays.items():
        assert t[k].tolist() == a.tolist(), k
    assert tensor_from_numpy(arrays["u32"], CPU).tolist() == [0xFFFFFFFF, 3]
