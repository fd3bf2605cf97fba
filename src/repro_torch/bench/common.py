"""Shared helpers of the port's benchmarks: the ``name,value,derived``
reporter and the timers, one for the host clock and one for the card's
CUDA events."""
from __future__ import annotations

import time
from typing import Callable, Dict, List

import torch


class Reporter:
    """Collects ``name,value,derived`` rows and prints them as CSV."""

    def __init__(self) -> None:
        self.rows: List[Dict[str, str]] = []

    def add(self, name: str, value, derived: str = "") -> None:
        self.rows.append({"name": name, "value": value, "derived": derived})
        print(f"{name},{value},{derived}", flush=True)

    def section(self, title: str) -> None:
        print(f"\n# --- {title} ---", flush=True)


def time_call(fn: Callable, *args, warmup: int = 1, iters: int = 5) -> float:
    """Median wall-clock seconds of ``fn(*args)`` (post-warmup) on the
    host clock; a CUDA result is synchronised inside the timed call."""
    def call():
        out = fn(*args)
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        return out
    for _ in range(warmup):
        call()
    ts = []
    for _ in range(iters):
        t0 = time.perf_counter()
        call()
        ts.append(time.perf_counter() - t0)
    ts.sort()
    return ts[len(ts) // 2]


def cuda_ms(fn: Callable, reps: int, warmup: int = 2) -> float:
    """Milliseconds of one ``fn()`` on the card: CUDA events around
    ``reps`` calls after ``warmup``, divided by ``reps``."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps
