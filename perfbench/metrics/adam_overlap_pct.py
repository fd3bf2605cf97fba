"""The share of the host Adam's busy time during which the card was busy
too: the union of the ``adam.update`` spans (every I/O worker) less its
overlap with the device's idle gaps, over that union, in %."""
from harness.devtrace import union
from harness.hostspans import overlap, window_spans


def read(w):
    spans = window_spans(w)
    if spans is None:
        return None
    total, merged = union([(t0, t1) for _tr, name, _c, t0, t1, _ in spans
                           if name == "adam.update" and t1 is not None])
    if total <= 0:
        return None
    return 100.0 * (total - overlap(merged, w.device.gaps)) / total
