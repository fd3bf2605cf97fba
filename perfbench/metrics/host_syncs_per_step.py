"""Times a step the executor's host waits for the card (``float(loss)``
a micro-batch, ``BARRIER``): its ``sync`` spans inside the window's
steps, over the steps."""
from harness.hostspans import HOST, step_envelopes, window_spans


def read(w):
    spans = window_spans(w)
    if spans is None:
        return None
    steps = step_envelopes(spans)
    if not steps:
        return None
    n = sum(1 for track, name, _cat, t0, t1, _ in spans
            if track == HOST and name == "sync" and t1 is not None
            and any(a <= t0 and t1 <= b for a, b in steps))
    return n / len(steps)
