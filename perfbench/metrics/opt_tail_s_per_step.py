"""Seconds a step the executor waits, after the backward, for the host
optimizer (the engine's ``phase_time["opt_wait"]``)."""


def read(w):
    t = w.phase_time.get("opt_wait")
    return None if t is None else t / w.steps
