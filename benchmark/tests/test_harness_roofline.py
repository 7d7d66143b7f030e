"""The rooflines' byte counts of 4x4-MB pictures against hand counts."""

import pytest

import streamgen
from reference import h264
from reference.motion import derive_motion
from roofline import PEAK_HBM_BYTES_PER_S, share


def counted(pics, w, h):
    motion = [derive_motion(p, w, h) if not p.idr else None
              for p in pics]
    counts = []
    list(h264.decode_gops([pics], [motion], w, h, "cpu", counts=counts))
    return [c[0] for c in counts]


def idr(w, h):
    p = streamgen.Picture(w * h, True, 0, 0, 26)
    p.kind[:] = streamgen.I4X4
    p.dc[:] = 11
    return p


def test_deblock_reads_of_an_intra_picture():
    """Every edge of an all-intra picture has bS 3 or 4. Luma: the lines
    across the vertical edges at x = 4, 8, ..., 60 read every column, so
    all 64 x 64 samples. Chroma, per plane: the edges at 4, 8, ..., 28
    read columns (and rows) 2 to 29, so all 32 x 32 samples but the 16
    whose column and row both lie in {0, 1, 30, 31}."""
    c = counted([idr(4, 4)], 4, 4)[0]
    assert c["deblock_read"] == 64 * 64 + 2 * (32 * 32 - 16)
    assert 0 < c["deblock_written"] <= c["deblock_read"]


def test_deblock_reads_of_one_mb():
    """One MB has no MB edge to filter: its internal luma edges at 4, 8,
    12 read all 16 x 16 samples; its internal chroma edge at 4 reads
    columns 2-5 and rows 2-5 of each 8 x 8 plane: 32 + 32 - 16."""
    c = counted([idr(1, 1)], 1, 1)[0]
    assert c["deblock_read"] == 256 + 2 * 48


def test_mc_reads_of_a_still_skipped_picture():
    """All P_Skip after an IDR picture: every MV is (0, 0) (the first
    MB's neighbours are unavailable, the rest copy a zero MV with
    reference 0), so prediction reads each reference sample once, 64 x
    64 luma and 2 x 32 x 32 chroma, and writes all 16 MBs' 384 samples."""
    p = streamgen.Picture(16, False, 1, 1, 26)
    c = counted([idr(4, 4), p], 4, 4)[1]
    assert c["mc_read"] == 64 * 64 + 2 * 32 * 32
    assert c["mc_written"] == 16 * 384
    # nothing to filter: equal MVs and references, no coefficients
    assert c["deblock_read"] == 0 and c["deblock_written"] == 0


def test_mc_reads_of_a_half_sample_mv():
    """One 16x16 partition with MV (2, 0) (a horizontal half sample) in a
    1x1-MB picture: every 4x4 block reads its 4 rows across columns x-2
    .. x+6, clamped to the 16 columns: all 256 luma samples; chroma MV
    (2, 0) in eighths: 2x2 blocks read 3 columns, 2 rows, all 8 x 8."""
    p = streamgen.Picture(1, False, 1, 1, 26)
    p.kind[0] = streamgen.P16X16
    p.mvd[0, 0] = (2, 0)
    c = counted([idr(1, 1), p], 1, 1)[1]
    assert c["mc_read"] == 256 + 2 * 64


def test_share():
    assert share(PEAK_HBM_BYTES_PER_S, 1.0) == pytest.approx(100.0)
    assert share(PEAK_HBM_BYTES_PER_S, 4.0) == pytest.approx(25.0)
    assert share(1e6, 0.0) is None and share(0, 1.0) is None
