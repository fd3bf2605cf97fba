"""What the readers of the program's host spans take from it: the ring of
the tracer the program last enabled (``repro_torch.obs.tracer.last()``),
which in a traced run holds the window, cleared at its start and stopped
at its end, and outlives the engine.

Only a traced run (``w.device`` set) reads that ring: an untraced run
enables no tracer, and the one last enabled belongs to an earlier run of
the same process. An untraced run, a program without that tracer, or a
ring that dropped spans gives ``None``, and its readers report nothing.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

from harness.devtrace import union

EXEC = "exec"              # the executor's plan ops, one span each
HOST = "exec.host"         # the executor thread's host work inside them


def window_spans(w) -> Optional[list]:
    """The traced window's spans, or None (an untraced run, no such
    tracer, spans dropped)."""
    if w.device is None:
        return None
    try:
        from repro_torch.obs import tracer
    except ImportError:
        return None
    last = getattr(tracer, "last", None)
    tr = last() if last is not None else None
    if tr is None or tr.dropped:
        return None
    return tr.spans()


def step_envelopes(spans) -> List[Tuple[float, float]]:
    """Each step of the window from its first plan op's start to its last
    plan op's end (``finish()`` lies outside every step)."""
    env = {}
    for track, _name, cat, t0, t1, args in spans:
        if track == EXEC and cat == "plan" and t1 is not None:
            step = (args or {}).get("step")
            lo, hi = env.get(step, (t0, t1))
            env[step] = (min(lo, t0), max(hi, t1))
    return sorted(env.values())


def overlap(merged, windows) -> float:
    """Seconds of the disjoint intervals ``merged`` inside the disjoint
    intervals ``windows``."""
    windows = sorted(windows)
    total = 0.0
    for lo, hi in merged:
        for a, b in windows:
            if b <= lo:
                continue
            if a >= hi:
                break
            total += min(hi, b) - max(lo, a)
    return total


def host_seconds_per_step(w, keep) -> Optional[float]:
    """Union of the executor thread's host spans that ``keep(name, cat)``
    selects, inside the window's steps, over the steps."""
    spans = window_spans(w)
    if spans is None:
        return None
    steps = step_envelopes(spans)
    if not steps:
        return None
    iv = [(t0, t1) for track, name, cat, t0, t1, _ in spans
          if track == HOST and t1 is not None and keep(name, cat)]
    _, merged = union(iv)
    return overlap(merged, steps) / len(steps)
