"""Span-based flight recorder for the offload stack.

One ``Tracer`` instance is shared by every layer that touches bytes —
the plan executor, the ``IOEngine`` channel threads, and the hint
coordinators. It is **off by default**: recording is gated by the
single ``enabled`` flag, and every instrumentation site tests that flag
*before* taking timestamps or building args, so the disabled path is
one attribute read per site (nothing measurable; acceptance-gated by
the paced-SSD smoke in ``check_smoke.py``).

Spans live in a bounded ring (``collections.deque(maxlen=...)``) under
one lock — a long traced run degrades to "most recent N spans" instead
of unbounded memory, and ``dropped`` counts the evictions so exports
are honest about truncation. Each span is a flat tuple
``(track, name, cat, t0, t1, args)``; ``t1 is None`` marks an instant
event. Tracks map 1:1 onto Chrome trace ``tid``s: one per I/O channel
thread (queue-wait + transfer slices), one for the plan executor, and
one per hint stream.

``export_chrome(path)`` writes the Chrome trace-event JSON format
(``{"traceEvents": [...]}`` with ``ph="X"`` complete events, ``ph="i"``
instants and ``ph="M"`` thread-name metadata) — loadable directly in
Perfetto / ``chrome://tracing``. ``summary()`` reduces the ring to the
per-route byte/seconds aggregates that ``metrics_snapshot()`` embeds
and ``obs.reconcile`` / ``perfmodel.machine_from_snapshot`` consume.
"""
from __future__ import annotations

import json
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

Span = Tuple[str, str, str, float, Optional[float], Optional[dict]]

#: Span categories (the ``cat`` field). Queue-wait and execution are
#: separate categories so aggregation never conflates the two.
CAT_IO_CHUNK = "io.chunk"      # chunk execution on a path channel
CAT_IO_QUEUE = "io.queue"      # chunk queue-wait (submit -> start)
CAT_IO_REQ = "io.req"          # request-body execution (front pool)
CAT_IO_REQ_QUEUE = "io.req.queue"
CAT_PLAN = "plan"              # one span per executed plan op
CAT_HINT = "hint"              # hint lifecycle (issued -> outcome)
CAT_FAULT = "io.fault"         # instants: retries, failovers, CRC errors


def _union_seconds(intervals: List[Tuple[float, float]]) -> float:
    """Total length of the union of ``(t0, t1)`` intervals — the
    wall-clock envelope a set of (possibly concurrent) chunk transfers
    actually occupied. Disjoint intervals sum; overlapping ones count
    once."""
    if not intervals:
        return 0.0
    total = 0.0
    cur_lo = cur_hi = None
    for lo, hi in sorted(intervals):
        if cur_hi is None or lo > cur_hi:
            if cur_hi is not None:
                total += cur_hi - cur_lo
            cur_lo, cur_hi = lo, hi
        elif hi > cur_hi:
            cur_hi = hi
    total += cur_hi - cur_lo
    return total


class Tracer:
    """Thread-safe ring-buffered span recorder (see module docstring).

    Callers must gate on ``tracer.enabled`` BEFORE computing timestamps;
    ``record`` itself does not re-check, so the off path never reaches
    it."""

    def __init__(self, capacity: int = 1 << 16):
        self.enabled = False
        self._capacity = int(capacity)
        self._lock = threading.Lock()
        self._spans: deque = deque(maxlen=self._capacity)
        self._dropped = 0
        # all exported timestamps are relative to this epoch
        self._epoch = time.perf_counter()

    # ---------------- control ----------------
    def enable(self):
        self.enabled = True

    def disable(self):
        self.enabled = False

    def clear(self):
        with self._lock:
            self._spans.clear()
            self._dropped = 0
            self._epoch = time.perf_counter()

    @property
    def dropped(self) -> int:
        with self._lock:
            return self._dropped

    def __len__(self) -> int:
        with self._lock:
            return len(self._spans)

    # ---------------- recording ----------------
    def record(self, track: str, name: str, cat: str, t0: float,
               t1: Optional[float], **args):
        """Append one complete span (or instant when ``t1 is None``).
        ``args`` values must be JSON-serializable scalars."""
        with self._lock:
            if len(self._spans) == self._capacity:
                self._dropped += 1
            self._spans.append((track, name, cat, t0, t1, args or None))

    def instant(self, track: str, name: str, cat: str, **args):
        self.record(track, name, cat, time.perf_counter(), None, **args)

    def spans(self) -> List[Span]:
        with self._lock:
            return list(self._spans)

    # ---------------- reduction ----------------
    def summary(self) -> dict:
        """Flat aggregates for ``metrics_snapshot()``: per-route chunk
        transfer time/bytes and queue-wait time, measured from the
        channel-thread spans.

        Concurrency semantics (the live-rate feed contract): a striped
        device runs P path-channel threads CONCURRENTLY, so per-route
        ``busy_s`` (the plain sum of chunk-span durations across all
        channels) over-counts wall time by up to P× — ``bytes /
        busy_s`` would read ~1/P of the aggregate rate the device
        actually delivered. ``busy_wall_s`` is therefore the measure
        rates must divide by: the UNION of the chunk-span intervals per
        route, which equals the summed durations when channels run
        serially and the wall-clock envelope when they overlap (a
        single channel reduces to ``busy_s`` exactly). ``rate_bps =
        bytes / busy_wall_s`` is the aggregate effective rate —
        the feed for ``perfmodel.machine_from_snapshot``. ``channels``
        counts the distinct threads that carried the route.

        Per-path splits: chunk spans on channel threads carry the SSD
        path index, so each route also reports ``per_path`` (path ->
        bytes/busy_s/ops/rate_bps, keys stringified for JSON
        round-trip). A path channel is a single thread, so its spans
        never overlap and per-(route, path) ``busy_s`` IS that path's
        wall occupancy — ``rate_bps = bytes / busy_s`` measures the
        DEVICE's achieved rate no matter how few chunks placement sent
        it. Per-path bytes sum exactly to the route's ``bytes``
        (placement moves bytes between paths, never between routes);
        ``obs.reconcile`` asserts that invariant."""
        routes: Dict[str, dict] = {}
        intervals: Dict[str, list] = {}
        tracks: Dict[str, set] = {}
        n_spans = 0
        for track, _name, cat, t0, t1, args in self.spans():
            n_spans += 1
            if t1 is None or cat not in (CAT_IO_CHUNK, CAT_IO_QUEUE):
                continue
            route = (args or {}).get("route") or "?"
            d = routes.setdefault(route, {"bytes": 0, "busy_s": 0.0,
                                          "queue_s": 0.0, "ops": 0,
                                          "per_path": {}})
            if cat == CAT_IO_QUEUE:
                d["queue_s"] += t1 - t0
            else:
                d["busy_s"] += t1 - t0
                d["bytes"] += int((args or {}).get("nbytes", 0))
                d["ops"] += 1
                intervals.setdefault(route, []).append((t0, t1))
                tracks.setdefault(route, set()).add(track)
                path = (args or {}).get("path")
                if path is not None:
                    pp = d["per_path"].setdefault(
                        str(path), {"bytes": 0, "busy_s": 0.0, "ops": 0})
                    pp["bytes"] += int((args or {}).get("nbytes", 0))
                    pp["busy_s"] += t1 - t0
                    pp["ops"] += 1
        for route, d in routes.items():
            wall = _union_seconds(intervals.get(route, []))
            d["busy_wall_s"] = wall
            d["channels"] = len(tracks.get(route, ()))
            d["rate_bps"] = d["bytes"] / wall if wall > 0 else 0.0
            for pp in d["per_path"].values():
                pp["rate_bps"] = (pp["bytes"] / pp["busy_s"]
                                  if pp["busy_s"] > 0 else 0.0)
        return {"enabled": self.enabled, "spans": n_spans,
                "dropped": self.dropped, "routes": routes}

    # ---------------- export ----------------
    def export_chrome(self, path: str) -> str:
        """Write the ring as Chrome trace-event JSON and return ``path``.
        One ``tid`` (track) per channel thread / executor / hint stream,
        named via ``ph="M"`` thread_name metadata."""
        tids: Dict[str, int] = {}
        events: List[dict] = []

        def tid_of(track: str) -> int:
            tid = tids.get(track)
            if tid is None:
                tid = tids[track] = len(tids) + 1
                events.append({"ph": "M", "pid": 1, "tid": tid,
                               "name": "thread_name",
                               "args": {"name": track}})
            return tid

        for track, name, cat, t0, t1, args in self.spans():
            ev = {"pid": 1, "tid": tid_of(track), "name": name, "cat": cat,
                  "ts": (t0 - self._epoch) * 1e6}
            if t1 is None:
                ev["ph"] = "i"
                ev["s"] = "t"                    # thread-scoped instant
            else:
                ev["ph"] = "X"
                ev["dur"] = max(0.0, (t1 - t0) * 1e6)
            if args:
                ev["args"] = args
            events.append(ev)
        doc = {"traceEvents": events, "displayTimeUnit": "ms",
               "otherData": {"dropped": self.dropped,
                             "capacity": self._capacity}}
        with open(path, "w") as f:
            json.dump(doc, f)
        return path
