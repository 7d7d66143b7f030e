"""The FIFO slot-pool rotation of the port's copy of the C++ front-end
(h264bsd_tpu_torch/frontend/csrc/dpb.cpp, Dpb::allocate_image), through
its binding: with slot_margin = M, the slot id a picture frees waits in a
FIFO pool of M spare ids, so no id is issued twice within M + 1
consecutive allocations. The windows of decode_stream rely on it (a
window of up to WINDOW frames, slot_margin=WINDOW, never writes one ring
slot twice: models/decoder.py). Held on a clean stream and two corrupted
ones (their losses conceal and their frame_num gaps allocate slots of
non-existing frames), for several margins, with the ids equal to the
JAX package's front-end's."""

import json
from pathlib import Path

import pytest

from h264bsd_tpu.frontend import binding as jfe
from h264bsd_tpu_torch.frontend import binding as fe
from h264bsd_tpu_torch.utils.recorded import make_recorded_stream

REF = json.loads((Path(__file__).parents[1] / "h264bsd_tpu_torch" /
                  "testdata" / "reference_checksums.json").read_text())
# a clean stream of six references; a corrupted one with two lost
# pictures and a gap; a corrupted one whose IDR is concealed
STREAMS = ("six_ref_cycle", "fuzz_longterm_s3", "fuzz_frame_num_gap_s3")


def allocations(binding, data, margin):
    """The slot ids the front-end allocates, in order (a picture's
    non-existing frames before it), one list per activated sequence,
    and the effective margins."""
    dec = binding.FrontendDecoder(slot_margin=margin)
    seqs, margins, pos = [], [], 0
    while pos < len(data):
        status, read = dec.decode(data, 0, pos)
        pos += read
        if status == binding.HDRS_RDY:
            seqs.append([])
        elif status == binding.PIC_RDY:
            seqs[-1] += dec.take_non_existing() + [dec.pic_info()["slot"]]
            margins.append(dec.stream_info()["slot_margin"])
            while dec.next_output() is not None:
                pass
        elif status >= binding.ERROR and read == 0:
            break
    dec.close()
    return seqs, margins


@pytest.mark.parametrize("margin", [1, 2, 3, 16])
@pytest.mark.parametrize("name", STREAMS)
def test_a_freed_slot_waits_for_the_margin(name, margin):
    """Every margin + 1 consecutive allocations of a sequence issue
    distinct ids, the spare ids (those above the DPB's own) among them.
    The margin in effect is the one requested, clamped so that ids stay
    below 32: these streams' level allows a 16-frame DPB, so 16 becomes
    15, which still keeps the frames of a window of WINDOW = 16 apart."""
    data = make_recorded_stream(REF[name])
    seqs, margins = allocations(fe, data, margin)
    assert (seqs, margins) == allocations(jfe, data, margin)
    assert set(margins) == {min(margin, 15)}
    eff = margins[0]
    assert sum(map(len, seqs)) >= 4
    for slots in seqs:
        for at in range(len(slots)):
            window = slots[at:at + eff + 1]
            assert len(set(window)) == len(window), (at, slots)
    slots = [s for seq in seqs for s in seq]
    own = allocations(fe, data, 0)[0]
    assert max(slots) > max(s for seq in own for s in seq)


def test_without_a_margin_ids_come_back_sooner():
    """slot_margin 0 leaves the DPB's own ids: ippp_4x4's two slots
    alternate, so a freed id is issued again two allocations later (why
    decode_stream asks for a margin); with a margin of 2 they wait."""
    data = make_recorded_stream(REF["ippp_4x4"])
    assert allocations(fe, data, 0)[0] == [[1, 0, 1, 0]]
    assert allocations(fe, data, 2)[0] == [[2, 3, 1, 0]]
