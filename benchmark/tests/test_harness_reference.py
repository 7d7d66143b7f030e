"""The plain reference decodes the benchmark's streams as the program
does, bit for bit, on the CPU at small sizes; its control (8-bit
intermediates in the luma centre half-sample) does not."""

import pytest
import torch

import streamgen
from reference import h264
from reference.motion import derive_motion
from h264bsd_tpu_torch.models.decoder import decode_stream


def reference(gops, w, h, control=False):
    motion = [[derive_motion(p, w, h) if not p.idr else None
               for p in pics] for _, pics in gops]
    return list(h264.decode_gops([pics for _, pics in gops], motion, w, h,
                                 "cpu", control=control))


def mismatches(planes, ref, b):
    return sum(not all(torch.equal(a[i], r[i][b]) for i in range(3))
               for a, r in zip(planes, ref))


@pytest.mark.parametrize("w,h,n,seeds,qps", [
    (4, 4, 16, (1, 2), (26, 34)), (5, 3, 16, (77, 2 ** 40 + 5), (22, 30)),
    (8, 6, 20, (5, 6), (30, 26)), (3, 9, 16, (11, 12), (26, 22))])
def test_reference_matches_the_program(w, h, n, seeds, qps):
    gops = [streamgen.make_motion_gop(w, h, n, s, q)
            for s, q in zip(seeds, qps)]
    ref = reference(gops, w, h)
    for b, (data, _) in enumerate(gops):
        planes = [pic.planes for pic in decode_stream(data, device="cpu")]
        assert len(planes) == n
        assert mismatches(planes, ref, b) == 0


def test_control_is_not_correct():
    """The control at a test's size: every P picture differs."""
    w, h, n = 4, 4, 16
    gops = [streamgen.make_motion_gop(w, h, n, s, 26) for s in (3, 4, 5)]
    ref = reference(gops, w, h)
    ctl = reference(gops, w, h, control=True)
    for b in range(len(gops)):
        bad = sum(not all(torch.equal(c[i][b], r[i][b]) for i in range(3))
                  for c, r in zip(ctl, ref))
        assert bad >= n // 2


def test_motion_vectors_follow_the_partitions():
    """A P_Skip MB at the picture's top-left corner predicts (0, 0); in
    the P_8x8 MB beside it, the first 4x4 sub-partition's neighbours B
    and C are outside the picture, so its prediction is A's MV, (0, 0),
    and its MV is its MVD; the second one's is that plus its own MVD
    (A is the first, B and C are outside)."""
    w, h = 2, 1
    pic = streamgen.Picture(2, False, 1, 1, 26)
    pic.kind[:] = [streamgen.SKIP, streamgen.P8X8]
    pic.sub[1] = 3
    pic.mvd[1, :16] = [(k + 1, -k) for k in range(16)]
    mv, ref = derive_motion(pic, w, h)
    assert (mv[:, :4] == 0).all() and (ref == 0).all()
    assert tuple(mv[0, 4]) == (1, 0) and tuple(mv[0, 5]) == (3, -1)
