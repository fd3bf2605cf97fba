"""The share of the bytes copied between the card and host memory inside
the window's steps that went through pinned host memory: the ``nbytes``
of the executor's ``copy.d2h`` / ``copy.h2d`` spans whose ``pinned`` is
true, over the ``nbytes`` of all of them, in %. A span counts when it
lies inside one of the window's steps. No such span gives no reading."""
from harness.hostspans import HOST, step_envelopes, window_spans


def read(w):
    spans = window_spans(w)
    if spans is None:
        return None
    steps = step_envelopes(spans)
    if not steps:
        return None
    pinned = total = 0
    for track, name, _cat, t0, t1, args in spans:
        if track != HOST or name not in ("copy.d2h", "copy.h2d") \
                or t1 is None:
            continue
        if not any(a <= t0 and t1 <= b for a, b in steps):
            continue
        n = int((args or {}).get("nbytes", 0))
        total += n
        if (args or {}).get("pinned") is True:
            pinned += n
    if total <= 0:
        return None
    return 100.0 * pinned / total
