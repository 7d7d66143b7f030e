"""The schedules of the port's dependency-driven kernels, on the CPU.

K2 (csrc/intra_list.cu) reconstructs a listed MB once each of its 8
neighbours listed before it is done; K1 (csrc/deblock_wf.cu) filters MB
(r, c) once (r, c-1), (r-1, c) and (r-1, c+1) are done; K7
(csrc/intra_wf.cu) walks each MB row left to right in one block, MB c
once the row above has done MB c+1, and both intra kernels run an
Intra_4x4 MB's 16 blocks in 10 steps on the anti-diagonals of its block
grid (csrc/intra_mb.cuh). A CUDA kernel runs only on the card, so the
rules are held here through their plain versions (list_dependency_levels,
and K1's and K7's schedules and the 10-step chain emulated below):

- K2's levels walked group by group give the JAX package's serial list
  walk, byte for byte, on lists in raster order (what the front-end
  ships), in a shuffled order and on sparse lists;
- K1's levels, and the MBs K7's rows do in each round, are the
  anti-diagonals of the wavefront;
- K7's schedule with the 10-step chain equals the JAX package's serial
  walk byte for byte, for any above-right availability bits, because
  blocks 5 and 13 read their above-right pels from a copy taken before
  the chain; without the copy it differs;
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
from h264bsd_tpu_torch.ops.intra import (I4_WEIGHTS, intra_mb_chroma,
                                        intra_mbs, intra_walk, predict_4x4)
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


def _row_progress_rounds(width_mbs, height_mbs):
    """K7's schedule, round by round: in each round every row whose next
    MB c has the row above's progress (its MBs done, as at the start of
    the round) at least min(c + 2, width) does that MB. Returns the MBs
    done in each round."""
    progress = [0] * height_mbs
    rounds = []
    while min(progress) < width_mbs:
        start = list(progress)
        done = []
        for r, c in enumerate(start):
            if c < width_mbs and (r == 0 or start[r - 1] >= min(
                    c + 2, width_mbs)):
                done.append(r * width_mbs + c)
                progress[r] += 1
        rounds.append(done)
    return rounds


@pytest.mark.parametrize("dims", [(6, 4), (3, 7), (20, 12), (3, 40),
                                  (40, 1), (1, 5), (2, 3)])
def test_row_progress_rounds_are_the_anti_diagonals(dims):
    assert _row_progress_rounds(*dims) == [sorted(d) for d in
                                           anti_diagonals(*dims) if d]


def _i4_steps():
    """The raster blocks of each step of the Intra_4x4 chain, the upper
    block first, as intra_mb_compute derives them from the step k."""
    steps = []
    for k in range(10):
        blocks = []
        for slot in (0, 1):
            by = max(0, (k - 2) >> 1) + slot
            bx = k - 2 * by
            if bx >= 0 and by < 4:
                blocks.append(4 * by + bx)
        steps.append(blocks)
    return steps


def test_i4_steps_cover_every_block_after_its_neighbours():
    steps = _i4_steps()
    step_of = {b: k for k, blocks in enumerate(steps) for b in blocks}
    assert sorted(step_of) == list(range(16))
    assert max(len(b) for b in steps) == 2 and len(steps) == 10
    for b, k in step_of.items():
        by, bx = divmod(b, 4)
        for dy, dx in ((0, -1), (-1, -1), (-1, 0), (-1, 1)):
            if 0 <= by + dy < 4 and 0 <= bx + dx < 4:
                assert step_of[4 * (by + dy) + bx + dx] < k


def _taps():
    """intra_stage_taps (csrc/intra_mb.cuh) in Python: per mode and pel
    of I4_WEIGHTS, its non-zero weights packed 7 bits each, neighbour
    index | weight << 4."""
    taps = []
    for row in I4_WEIGHTS.reshape(9 * 16, 13).tolist():
        packed, k = 0, 0
        for j, w in enumerate(row):
            if w:
                packed |= (j | w << 4) << (7 * k)
                k += 1
        taps.append(packed)
    return taps


def test_i4_taps_give_the_weight_rows_dot_product():
    """The kernels keep at most 3 taps of 3-bit weights per pel: every
    row of I4_WEIGHTS fits, and the unpacked taps give its dot product."""
    assert ((I4_WEIGHTS != 0).sum(-1) <= 3).all()
    assert I4_WEIGHTS.min() >= 0 and I4_WEIGHTS.max() <= 7
    n = np.random.default_rng(24).integers(0, 256, (9 * 16, 13))
    got = [sum(((tp >> (7 * k + 4)) & 7) * n[i, (tp >> (7 * k)) & 15]
               for k in range(3)) for i, tp in enumerate(_taps())]
    np.testing.assert_array_equal(
        got, (I4_WEIGHTS.reshape(9 * 16, 13) * n).sum(-1))


def _i4_luma_in_steps(y, mb, width_mbs, modes, avail, res, pre_copy):
    """One Intra_4x4 MB's luma in place, in the 10-step order: each step's
    blocks read the plane as it stands before the step, then write. With
    pre_copy, blocks 5 and 13 read their above-right pels from a copy of
    the MB's pels taken before the first step, as the kernels do."""
    height, width = y.shape
    x0, y0 = (mb % width_mbs) * 16, (mb // width_mbs) * 16
    pre = {5: y[y0 + 3, x0 + 8:x0 + 12].clone(),
           13: y[y0 + 11, x0 + 8:x0 + 12].clone()}
    for blocks in _i4_steps():
        out = []
        for rb in blocks:
            bx, by = x0 + 4 * (rb % 4), y0 + 4 * (rb // 4)
            cols = (torch.arange(9) + bx - 1).clamp(0, width - 1)
            n = torch.cat([y[max(by - 1, 0), cols],
                           y[by:by + 4, max(bx - 1, 0)]]).int()
            if pre_copy and rb in pre:
                n[5:9] = pre[rb]
            pred = predict_4x4(modes[rb:rb + 1], n[None],
                               avail[rb:rb + 1].int())[0]
            r0, c0 = 4 * (rb // 4), 4 * (rb % 4)
            out.append((bx, by, (pred + res[r0:r0 + 4, c0:c0 + 4]).clamp(
                0, 255)))
        for bx, by, v in out:
            y[by:by + 4, bx:bx + 4] = v.to(torch.uint8)


def _k7_walk(case, w, h, pre_copy):
    """K7 emulated: the MBs of each round of its schedule, each Intra_4x4
    MB's luma in the 10-step order, everything else as the plain version
    reconstructs it."""
    t = from_numpy(case, CPU)
    y, cb, cr = (t[k].clone() for k in PLANES)
    cls = t["mb_class"]
    for mbs in _row_progress_rounds(w, h):
        for mb in mbs:
            if int(cls[mb]) == 4:
                intra_mbs(y, cb, cr, torch.tensor([mb]),
                          *(t[k] for k in INTRA_STATE), w)
            elif int(cls[mb]) == 3:
                _i4_luma_in_steps(y, mb, w, t["i4_modes"][mb],
                                  t["i4_avail"][mb], t["resid_luma"][mb],
                                  pre_copy)
                ids = torch.tensor([mb])
                for p, plane in enumerate((cb, cr)):
                    intra_mb_chroma(plane, (ids % w) * 8, (ids // w) * 8,
                                    t["chroma_mode"][ids],
                                    t["mb_avail"][ids],
                                    t["resid_chroma"][ids, p])
    return y, cb, cr


def _k7_case(kind, w, h):
    if kind == "all_intra":
        return intra_case(23, w, h, all_intra=True)
    case = intra_case(23, w, h)
    if kind == "all_c":
        case["i4_avail"] = case["i4_avail"] | 4
    return case


def _jax_walk(case, w):
    ids = _intra_list(case, "raster")
    return _jax_list_walk(*(jnp.asarray(case[k]) for k in PLANES),
                          jnp.asarray(ids),
                          *(jnp.asarray(case[k]) for k in INTRA_STATE), w)


@pytest.mark.parametrize("dims", [(6, 4), (4, 4)])
@pytest.mark.parametrize("kind", ["random_c", "all_c", "all_intra"])
def test_k7_schedule_in_ten_steps_equals_jax_list_walk(dims, kind):
    case = _k7_case(kind, *dims)
    want = _jax_walk(case, dims[0])
    got = _k7_walk(case, *dims, pre_copy=True)
    for g, wnt, name in zip(got, want, PLANES):
        np.testing.assert_array_equal(g.numpy(), np.asarray(wnt), name)


@pytest.mark.parametrize("dims", [(6, 4), (4, 4)])
def test_ten_steps_without_the_copy_differ(dims):
    """Blocks 5 and 13 reading the reconstructed pels of blocks 2 and 10
    (the new order's state) give another picture when their above-right
    bit is set: the copy is what keeps the chain exact."""
    case = _k7_case("all_c", *dims)
    want = _jax_walk(case, dims[0])
    got = _k7_walk(case, *dims, pre_copy=False)
    assert not np.array_equal(got[0].numpy(), np.asarray(want[0]))


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
