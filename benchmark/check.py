"""How `correct` is decided: every picture a window handed on is compared
with the plain reference's picture of the same stream, GOP and index.

The reference (reference/) decodes every distinct GOP of the run once
from the syntax records streamgen kept while writing the streams: first
the motion vectors of every P picture, in worker processes, then the
pixels on `device`, picture k of all GOPs of one size together. It runs
after the window, once the program's state is freed. A picture is
correct when its digest (digest.py) equals the reference picture's: an
exact comparison, limit 0.
"""

from __future__ import annotations

import torch

from digest import digest
from reference import h264
from reference.motion import motion_task


# MBs of the pictures reconstructed at once (a 1080p picture has 8160)
BATCH_MBS = 65536


def reference_digests(streams, device, pool=None, control=False,
                      counts=None):
    """{(stream, gop, index): digest (3, 3) float64 on the host} of every
    distinct picture; counts, when a dict, gets each picture's sample
    counts for the rooflines (reference.h264.decode_pictures)."""
    w, h = streams.width_mbs, streams.height_mbs
    gops = [(i, g) for i in range(streams.n_streams)
            for g in range(streams.n_gops)]
    tasks = [(pic, w, h) for i, g in gops for pic in streams.gops[i][g][1]]
    motion = pool.map(motion_task, tasks) if pool is not None else \
        [motion_task(t) for t in tasks]
    n = streams.gop_len
    motion = {key: motion[k * n:(k + 1) * n] for k, key in enumerate(gops)}
    out = {}
    per = max(1, BATCH_MBS // (w * h))
    for start in range(0, len(gops), per):
        chunk = gops[start:start + per]
        got = [] if counts is not None else None
        planes = h264.decode_gops(
            [streams.gops[i][g][1] for i, g in chunk],
            [motion[key] for key in chunk], w, h, device,
            streams.num_ref_frames, control, got)
        for k, pics in enumerate(planes):
            d = digest(pics).cpu()
            for b, (i, g) in enumerate(chunk):
                out[(i, g, k)] = d[b]
        if counts is not None:
            for k, per_pic in enumerate(got):
                for b, (i, g) in enumerate(chunk):
                    counts[(i, g, k)] = per_pic[b]
    return out


def compare(win, streams, ref):
    """(pictures compared, mismatched, missing) of a window."""
    rows = win.digest_rows()
    bad = 0
    for (i, n), d in zip(win.keys, rows):
        g, k = streams.gop_of(n)
        if not torch.equal(d, ref[(i, g, k)]):
            bad += 1
    return len(win.keys), bad, win.missing
