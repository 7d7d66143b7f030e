"""Entry (models/decoder.py decode_stream): the share of the traced
window in which no operation ran on the card while the consumer thread
waited on an empty queue for the parse thread (its innermost span
h264.queue_wait): the device's idle time that the parse thread causes
(program_spans.py)."""

import program_spans

SOURCE = "device_trace"
UNIT = "%"
MOVES = "fps"


def read(ctx):
    st = program_spans.of(ctx)
    if st is None or st.window_s <= 0:
        return None
    idle = st.idle_seconds(st.innermost(st.consumer))
    return 100.0 * idle.get("h264.queue_wait", 0.0) / st.window_s
