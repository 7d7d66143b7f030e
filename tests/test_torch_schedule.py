"""The schedules of the port's dependency-driven kernels, on the CPU.

K2 (csrc/intra_list.cu) reconstructs a listed MB once each of its 8
neighbours listed before it is done; K1 (csrc/deblock_wf.cu) filters MB
(r, c) once (r, c-1), (r-1, c) and (r-1, c+1) are done. A CUDA kernel
runs only on the card, so the rules are held here through their plain
versions (list_dependency_levels, and K1's levels computed below):

- K2's levels walked group by group give the JAX package's serial list
  walk, byte for byte, on lists in raster order (what the front-end
  ships), in a shuffled order and on sparse lists;
- K1's levels are the anti-diagonals of the wavefront;
- every intra list the port's front-end ships is strictly ascending,
  unique and intra-only, so in practice K2 only ever waits on the left,
  above-left, above and above-right neighbours.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from h264bsd_tpu.ops import intra as jintra
from h264bsd_tpu_torch.frontend import binding as fe
from h264bsd_tpu_torch.models.decoder import WF_THRESH, caps_from_counts
from h264bsd_tpu_torch.models.state import from_numpy
from h264bsd_tpu_torch.ops import unpack as tunpack
from h264bsd_tpu_torch.ops.cuda_intra import (NEIGHBOURS,
                                              list_dependency_levels)
from h264bsd_tpu_torch.ops.deblock import anti_diagonals
from h264bsd_tpu_torch.ops.intra import intra_walk
from h264bsd_tpu_torch.utils import streamgen
from h264bsd_tpu_torch.utils.kernel_cases import INTRA_STATE, intra_case

CPU = torch.device("cpu")
PLANES = ("y", "cb", "cr")

# one compile per frame size: every list of a size has length nMB + 2
_jax_list_walk = jax.jit(jintra.intra_pass_list, static_argnums=(12,))


def _intra_list(case, kind):
    """Only intra MBs and padding (nMB): the JAX walk does not check an
    entry's class, the port skips non-intra entries."""
    n = case["mb_class"].shape[0]
    intra = np.flatnonzero((case["mb_class"] == 3) | (case["mb_class"] == 4))
    rng = np.random.default_rng(len(intra))
    if kind == "shuffled":
        intra = rng.permutation(intra)
    elif kind == "sparse":
        intra = np.sort(rng.choice(intra, len(intra) // 3, replace=False))
    return np.concatenate([intra, np.full(n + 2 - len(intra), n)]).astype(
        np.int32)


def _neighbours(a, b, width_mbs):
    (ra, ca), (rb, cb) = divmod(a, width_mbs), divmod(b, width_mbs)
    return (rb - ra, cb - ca) in NEIGHBOURS


@pytest.mark.parametrize("dims", [(6, 4), (4, 4)])
@pytest.mark.parametrize("kind", ["raster", "shuffled", "sparse"])
def test_list_levels_walk_equals_jax_list_walk(dims, kind):
    w, h = dims
    case = intra_case(21, w, h)
    ids = _intra_list(case, kind)
    want = _jax_list_walk(*(jnp.asarray(case[k]) for k in PLANES),
                          jnp.asarray(ids),
                          *(jnp.asarray(case[k]) for k in INTRA_STATE), w)
    t = from_numpy(case, CPU)
    groups = list_dependency_levels(torch.from_numpy(ids), t["mb_class"], w,
                                    h)
    listed = [int(i) for i in ids if i < w * h]
    assert sorted(sum(groups, [])) == sorted(listed)
    for g in groups:
        assert not any(_neighbours(a, b, w) for a in g for b in g)
    if kind != "shuffled":
        # in raster order the critical path never exceeds the wavefront's
        assert len(groups) <= len(anti_diagonals(w, h))
    got = intra_walk(*(t[k].clone() for k in PLANES), groups,
                     *(t[k] for k in INTRA_STATE), w)
    for g, wnt, name in zip(got, want, PLANES):
        np.testing.assert_array_equal(g.numpy(), np.asarray(wnt), name)


@pytest.mark.parametrize("dims", [(6, 4), (3, 7), (40, 1), (2, 5)])
def test_levels_of_a_full_raster_list_are_the_anti_diagonals(dims):
    """All MBs intra and listed in raster order: K2's levels are K7's and
    K1's wavefront."""
    case = intra_case(22, *dims, all_intra=True)
    ids = np.arange(dims[0] * dims[1], dtype=np.int32)
    groups = list_dependency_levels(torch.from_numpy(ids),
                                    torch.from_numpy(case["mb_class"]),
                                    *dims)
    assert groups == [d for d in anti_diagonals(*dims) if d]


def test_list_levels_skip_padding_non_intra_and_repeats():
    mb_class = torch.tensor([3, 2, 4, 4, 3, 3])       # 3x2 MBs
    ids = torch.tensor([6, 1, 2, -1, 0, 2, 5, 99])
    # 6, -1 and 99 are padding, MB 1 is inter and MB 2's second entry a
    # repeat; 0 and 2 are not neighbours, 5 is 2's below neighbour
    assert list_dependency_levels(ids, mb_class, 3, 2) == [[2, 0], [5]]
    assert list_dependency_levels(torch.tensor([3]), mb_class, 3, 2) == [[3]]
    assert list_dependency_levels(torch.tensor([6, 7]), mb_class, 3,
                                  2) == []


def _deblock_levels(width_mbs, height_mbs):
    """K1's flag rule: MB (r, c) waits for (r, c-1), (r-1, c) and
    (r-1, c+1), so its level is 1 + the largest of theirs."""
    level = {}
    for r in range(height_mbs):
        for c in range(width_mbs):
            deps = [(r, c - 1), (r - 1, c), (r - 1, c + 1)]
            level[r, c] = 1 + max((level[d] for d in deps if d in level),
                                  default=-1)
    groups = [[] for _ in range(1 + max(level.values(), default=-1))]
    for (r, c), lv in level.items():
        groups[lv].append(r * width_mbs + c)
    return groups


@pytest.mark.parametrize("dims", [(6, 4), (3, 7), (20, 12), (3, 40),
                                  (40, 1), (1, 5), (2, 3)])
def test_deblock_levels_are_the_anti_diagonals(dims):
    assert _deblock_levels(*dims) == [d for d in anti_diagonals(*dims) if d]


def _front_end_lists(data):
    """(intra_ids, mb_class, nMB) of every picture of the stream, as the
    port's front-end ships them and unpack_blob / unpack_meta read them."""
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
            blob = dec.blob_compact(*caps, words * 4)
            (packed, stab, sids, _, eids, epay, iids, ipay,
             slice_ids) = tunpack.unpack_blob(tunpack.blob_words(blob, CPU),
                                              n, *caps)
            t = tunpack.unpack_meta(packed, stab, eids, epay, iids, ipay, n,
                                    slice_ids, sparse_ids=sids)
            out.append((iids, t["mb_class"], n))
            while dec.next_output() is not None:
                pass
        elif status >= fe.ERROR and read == 0:
            break
    dec.close()
    return out


@pytest.mark.parametrize("maker", [
    lambda: streamgen.make_intra_stress_stream(4, 4, 2),
    lambda: streamgen.make_ippp_stream(4, 4, 4),
    lambda: streamgen.make_intra_in_p_stream(False),
    lambda: streamgen.make_conformance_stream(num_slice_groups=2)],
    ids=["intra", "ippp", "intra_in_p", "slice_groups"])
def test_front_end_intra_lists_are_ascending_unique_and_intra(maker):
    pictures = _front_end_lists(maker())
    assert pictures
    listed_any = False
    for iids, mb_class, n in pictures:
        ids = iids.reshape(-1).tolist()
        real = [i for i in ids if 0 <= i < n]
        # the real entries first, then padding (nMB)
        assert ids == real + [n] * (len(ids) - len(real))
        assert all(a < b for a, b in zip(real, real[1:]))
        intra = ((mb_class == 3) | (mb_class == 4)).nonzero().flatten()
        assert real == intra.tolist()
        listed_any |= bool(real)
    assert listed_any
