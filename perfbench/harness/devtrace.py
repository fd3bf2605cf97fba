"""The device's side of a traced window, from ``torch.profiler``.

``DeviceTrace`` starts a profiler over CPU and CUDA activity, marks the
window with a ``record_function`` whose start is also taken on the host's
``perf_counter``, so host spans can be placed on the profiler's clock,
and reduces the kernel, copy and memset intervals it recorded to:

* ``busy_s``: the union of the device intervals inside the window
  (kernels, copies and memsets; a range's device-side annotation is no
  operation and is left out);
* ``by_name``: per device operation name, its summed time and count;
* ``gaps``: the idle intervals between device operations, longest first.

It reads ``kineto_results.events()`` directly and never builds the
profiler's per-op tree.
"""
from __future__ import annotations

import bisect
import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

WINDOW_MARK = "perfbench.window"


def union(intervals: List[Tuple[float, float]]) -> Tuple[float, list]:
    """(total length, merged intervals) of ``(lo, hi)`` pairs."""
    merged: list = []
    for lo, hi in sorted(intervals):
        if merged and lo <= merged[-1][1]:
            if hi > merged[-1][1]:
                merged[-1][1] = hi
        else:
            merged.append([lo, hi])
    return sum(hi - lo for lo, hi in merged), merged


class DeviceTrace:
    def __init__(self):
        self.busy_s = 0.0
        self.window_s = 0.0
        self.by_name: Dict[str, List[float]] = {}
        self.gaps: List[Tuple[float, float]] = []   # host perf_counter
        self.events = 0
        self._prof = None
        self._mark = None
        self._t0 = self._t1 = None

    def start(self):
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function
        self._prof = profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA])
        self._prof.__enter__()
        torch.cuda.synchronize()
        self._mark = record_function(WINDOW_MARK)
        self._t0 = time.perf_counter()
        self._mark.__enter__()

    def stop(self):
        """End the window (the caller has synchronised the device)."""
        self._mark.__exit__(None, None, None)
        self._t1 = time.perf_counter()
        self._prof.__exit__(None, None, None)
        self._reduce()

    def _reduce(self):
        import torch
        cuda = torch.autograd.DeviceType.CUDA
        evs = self._prof.profiler.kineto_results.events()
        anchor: Optional[int] = None
        dev = []
        for e in evs:
            if e.device_type() == cuda:
                # a range's device-side annotation spans the kernels it
                # holds: no operation of its own
                if e.name() == WINDOW_MARK or getattr(
                        e, "is_user_annotation", lambda: False)():
                    continue
                dev.append((e.start_ns(), e.start_ns() + e.duration_ns(),
                            e.name()))
            elif anchor is None and e.name() == WINDOW_MARK:
                anchor = e.start_ns()
        if anchor is None:
            raise RuntimeError("the profiler recorded no window mark")
        lo = anchor
        hi = anchor + int((self._t1 - self._t0) * 1e9)
        self.window_s = (hi - lo) / 1e9
        by_name: Dict[str, List[float]] = defaultdict(lambda: [0.0, 0])
        spans = []
        for s, e, name in dev:
            s, e = max(s, lo), min(e, hi)
            if e <= s:
                continue
            spans.append((s, e))
            rec = by_name[name]
            rec[0] += (e - s) / 1e9
            rec[1] += 1
        self.events = len(spans)
        busy, merged = union(spans)
        self.busy_s = busy / 1e9
        self.by_name = dict(by_name)
        edges = [lo] + [x for iv in merged for x in iv] + [hi]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        gaps.sort(key=lambda g: g[0] - g[1])
        # on the host's clock
        self.gaps = [(self._t0 + (a - lo) / 1e9, self._t0 + (b - lo) / 1e9)
                     for a, b in gaps]
        self._prof = None

    def kernel_time(self, patterns) -> Tuple[float, int]:
        """(summed seconds, launches of the first pattern) of the device
        operations whose name contains one of ``patterns``."""
        secs, count = 0.0, 0
        for name, (s, n) in self.by_name.items():
            if any(p in name for p in patterns):
                secs += s
                if patterns[0] in name:
                    count += n
        return secs, count

    def top_ops(self, k: int = 10) -> List[list]:
        return [[n, s] for n, (s, _) in sorted(
            self.by_name.items(), key=lambda kv: -kv[1][0])[:k]]


def attribute(gaps: List[Tuple[float, float]],
              spans: List[Tuple[float, float, str]]) -> Dict[str, float]:
    """Idle seconds by what the host was doing: each gap's overlap with
    the host spans ``(t0, t1, name)`` (one thread's, so disjoint), the
    rest under ``"(no plan op)"``."""
    spans = sorted(spans)
    starts = [s[0] for s in spans]
    out: Dict[str, float] = defaultdict(float)
    for a, b in gaps:
        covered = 0.0
        i = max(bisect.bisect_right(starts, a) - 1, 0)
        while i < len(spans) and spans[i][0] < b:
            lo, hi = max(spans[i][0], a), min(spans[i][1], b)
            if hi > lo:
                out[spans[i][2]] += hi - lo
                covered += hi - lo
            i += 1
        if b - a - covered > 0:
            out["(no plan op)"] += b - a - covered
    return dict(out)
