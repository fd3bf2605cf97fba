"""Host seconds a step the executor spends copying between the card and
host memory and staging those copies on the host: the union of its
``copy.d2h`` / ``copy.h2d`` / ``host.stage`` spans (category ``copy``)
inside the window's steps, over the steps. A copy's span starts once the
work queued before it on the card has drained; that wait is its own
``copy.wait`` span (category ``sync``) and is not counted here."""
from harness.hostspans import host_seconds_per_step


def read(w):
    return host_seconds_per_step(w, lambda name, cat: cat == "copy")
