"""Graphs and entry (models/graphs.py, Decoder._stage, _make_output):
milliseconds a picture handed on that the consumer thread spends feeding
the card, the self seconds of its h264.stage, h264.replay, h264.capture,
h264.eager and h264.output spans in the traced window over the
window's pictures (program_spans.py)."""

import program_spans

SOURCE = "device_trace"
UNIT = "ms/picture"
MOVES = "fps"


def read(ctx):
    st = program_spans.of(ctx)
    if st is None or not ctx.n_pictures:
        return None
    sec = st.self_seconds()
    return 1e3 * sum(sec.get((name, "consumer"), 0.0)
                     for name in program_spans.SUBMIT) / ctx.n_pictures
