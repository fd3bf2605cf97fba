"""Seconds a step in which some I/O chunk moved: the union of the
engine tracer's ``io.chunk`` spans, per whole step the tracer's ring
still holds (its ``dropped`` count is in the result's ``window``)."""


def read(w):
    return w.io_busy_s_per_step
