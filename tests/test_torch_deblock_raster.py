"""The raster deblocking of frames under 3 MBs wide (K8), on the CPU.

- The port's wrapper on CPU tensors (its plain raster walk) against the
  JAX package's raster Pallas kernel in interpret mode
  (deblock_frame_pallas_from_bs), on 1xN and 2xN frames.
- K8's schedule (csrc/deblock_wf.cu, deblock_raster_kernel) emulated
  with the plain per-MB filter: bands of RB_ROWS MB rows in two buffers,
  each band's halo rows copied from the band above once that is
  filtered, and every band written back without the rows the next band
  still filters. A CUDA kernel runs only on the card, so its band
  bookkeeping is held here, at the kernel's band height and at others.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from h264bsd_tpu.ops import deblock as jdeblock
from h264bsd_tpu.ops.pallas_deblock import deblock_frame_pallas_from_bs
from h264bsd_tpu_torch.ops.cuda_deblock import (deblock_frame_cuda_from_bs,
                                                deblock_raster_plain)
from h264bsd_tpu_torch.ops.deblock import deblock_walk
from h264bsd_tpu_torch.utils.kernel_cases import (DEBLOCK_STATE,
                                                  deblock_case,
                                                  deblock_inputs)

CPU = torch.device("cpu")
SOURCE = Path(__file__).parents[1] / "h264bsd_tpu_torch" / "csrc" / \
    "deblock_wf.cu"


def _kernel_band_rows():
    return int(re.search(r"#define RB_ROWS (\d+)",
                         SOURCE.read_text()).group(1))


def _planes(args):
    return tuple(a.clone() for a in args[:3])


@pytest.mark.parametrize("seed,dims", [(20, (1, 9)), (21, (2, 17))])
def test_plain_raster_matches_jax_pallas_kernel(seed, dims):
    w, h = dims
    case = deblock_case(seed, w, h)
    state = [jnp.asarray(case[k]) for k in DEBLOCK_STATE]
    bs = jdeblock.boundary_strengths(
        *(s.astype(jnp.int32) for s in state[:6]), w, h)
    thr = [jdeblock.edge_thresholds(state[6], state[4], state[7], state[8],
                                    state[9], w, h, chroma)
           for chroma in (False, True)]
    want = deblock_frame_pallas_from_bs(
        *(jnp.asarray(case[k]) for k in ("y", "cb", "cr")), *bs, *thr[0],
        *thr[1], w, h, interpret=True)
    args = deblock_inputs(case, w, h, CPU)
    got = deblock_frame_cuda_from_bs(*_planes(args), *args[3:], w, h)
    for g, wnt, name in zip(got, want, ("y", "cb", "cr")):
        np.testing.assert_array_equal(g.numpy(), np.asarray(wnt), name)


def _banded_raster(y, cb, cr, bs_left, bs_top, luma_thr, chroma_thr,
                   wm, hm, band_rows):
    """deblock_raster_kernel's schedule on the CPU. A band buffer holds one
    MB row more than the band: the last 4 luma (2 chroma) rows of that
    row are the halo; the others, and every parameter of that row, stay
    unread (bS 0). The halo of band 0 is a sentinel that must not reach
    the planes."""
    params = (bs_left, bs_top, *luma_thr, *chroma_thr)
    n_bands = -(-hm // band_rows)
    bufs = [dict(y=torch.full((16 * (band_rows + 1), 16 * wm), 0xEE,
                              dtype=torch.uint8),
                 c=[torch.full((8 * (band_rows + 1), 8 * wm), 0xEE,
                               dtype=torch.uint8) for _ in range(2)],
                 prm=[torch.zeros(((band_rows + 1) * wm,) + p.shape[1:],
                                  dtype=p.dtype) for p in params])
            for _ in range(2)]

    def rows_of(k):
        return min(band_rows, hm - k * band_rows)

    def load(k):
        b, r0, rows = bufs[k % 2], k * band_rows, rows_of(k)
        b["y"][16:16 + 16 * rows] = y[16 * r0:16 * (r0 + rows)]
        for bc, c in zip(b["c"], (cb, cr)):
            bc[8:8 + 8 * rows] = c[8 * r0:8 * (r0 + rows)]
        for bp, p in zip(b["prm"], params):
            bp.zero_()
            bp[wm:wm * (1 + rows)] = p[wm * r0:wm * (r0 + rows)]

    def store(k, last):
        b, r0, rows = bufs[k % 2], k * band_rows, rows_of(k)
        ly, end = (12 if k else 16), 16 + 16 * rows - (0 if last else 4)
        y[16 * r0 - 16 + ly:16 * r0 - 16 + end] = b["y"][ly:end]
        lc, end = (6 if k else 8), 8 + 8 * rows - (0 if last else 2)
        for bc, c in zip(b["c"], (cb, cr)):
            c[8 * r0 - 8 + lc:8 * r0 - 8 + end] = bc[lc:end]

    load(0)
    for k in range(n_bands):
        b = bufs[k % 2]
        if k:
            prev, lr = bufs[(k - 1) % 2], 16 * rows_of(k - 1)
            b["y"][12:16] = prev["y"][12 + lr:16 + lr]
            for bc, pc in zip(b["c"], prev["c"]):
                bc[6:8] = pc[6 + lr // 2:8 + lr // 2]
            store(k - 1, False)
        if k + 1 < n_bands:
            load(k + 1)
        rows = rows_of(k)
        deblock_walk(b["y"][:16 * (rows + 1)], b["c"][0][:8 * (rows + 1)],
                     b["c"][1][:8 * (rows + 1)],
                     [[wm + i] for i in range(rows * wm)], *b["prm"][:2],
                     tuple(b["prm"][2:5]), tuple(b["prm"][5:]), wm)
    store(n_bands - 1, True)
    return y, cb, cr


@pytest.mark.parametrize("band_rows", [None, 1, 3])
@pytest.mark.parametrize("seed,dims", [(22, (1, 9)), (23, (2, 17)),
                                       (24, (1, 40)), (25, (1, 1))])
def test_banded_schedule_equals_the_raster_walk(seed, dims, band_rows):
    band_rows = band_rows or _kernel_band_rows()
    args = deblock_inputs(deblock_case(seed, *dims), *dims, CPU)
    want = deblock_raster_plain(*_planes(args), *args[3:], *dims)
    got = _banded_raster(*_planes(args), *args[3:], *dims, band_rows)
    for g, w, name in zip(got, want, ("y", "cb", "cr")):
        assert torch.equal(g, w), name


def test_wider_frames_are_refused():
    args = deblock_inputs(deblock_case(26, 3, 2), 3, 2, CPU)
    with pytest.raises(ValueError, match="under 3 MBs wide"):
        deblock_frame_cuda_from_bs(*_planes(args), *args[3:], 3, 2)
