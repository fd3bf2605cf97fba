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

Stamps are ``time.perf_counter`` seconds (cheap). The tracer also keeps
clock anchors — a ``perf_counter_ns`` / ``time.time_ns`` pair, the
tightest bracket of a few reads — taken when recording starts
(``enable()`` / ``clear()``) and when it stops (``disable()``).
``to_unix_ns`` maps a stamp onto Unix nanoseconds by interpolating
between the two, which is the clock of ``torch.profiler``'s events
(``_KinetoEvent.start_ns()``), so host spans and device intervals of one
window can be compared directly; ``summary()["clock"]`` reports the
drift between the anchors.

``export_chrome(path)`` writes the Chrome trace-event JSON format
(``{"traceEvents": [...]}`` with ``ph="X"`` complete events, ``ph="i"``
instants and ``ph="M"`` thread-name metadata) — loadable directly in
Perfetto / ``chrome://tracing`` — on the time base that
``torch.profiler``'s ``export_chrome_trace`` writes (microseconds since
``baseTimeNanoseconds``), so the two files of one window line up when
opened together. ``summary()`` reduces the ring to the per-route
byte/seconds aggregates that ``metrics_snapshot()`` embeds and
``obs.reconcile`` / ``perfmodel.machine_from_snapshot`` consume.

Tracks: each I/O worker records on its own thread's name; every other
thread (the plan executor's) records its host work on ``HOST_TRACK``,
apart from the executor's one span per plan op on ``exec``
(:func:`thread_track`).
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
CAT_COPY = "copy"              # card <-> host copies and their host staging
CAT_SYNC = "sync"              # the host waiting for the card
CAT_OPT = "opt"                # host Adam updates and waits on them

#: the track of the host work a non-worker thread (the plan executor)
#: does inside its plan ops: copies, host staging, syncs, optimizer waits
HOST_TRACK = "exec.host"

#: libkineto's ``ChromeTraceBaseTime`` interval: ``torch.profiler``'s
#: Chrome export writes microseconds since the start of the current one
_KINETO_BASE_SECONDS = 7889238

_tls = threading.local()
_last: Optional["Tracer"] = None


def set_thread_track(name: str):
    """Name the calling thread's track (the I/O engine's workers)."""
    _tls.track = name


def thread_track() -> str:
    """The calling thread's track: an I/O worker's own name, else
    :data:`HOST_TRACK`."""
    return getattr(_tls, "track", HOST_TRACK)


def set_current_req(seq: int):
    """The sequence number of the request the calling worker runs."""
    _tls.req = seq


def current_req() -> int:
    """The request the calling thread is running (-1: none)."""
    return getattr(_tls, "req", -1)


def last() -> Optional["Tracer"]:
    """The tracer most recently enabled in this process (None before any):
    a tool that traced a window of an engine it does not hold reads the
    window here after the engine is gone."""
    return _last


def kineto_base_ns() -> int:
    """The ``baseTimeNanoseconds`` ``torch.profiler``'s Chrome export
    uses now."""
    t = int(time.time())
    return t // _KINETO_BASE_SECONDS * _KINETO_BASE_SECONDS * 1_000_000_000


def _anchor() -> Tuple[int, int]:
    """A ``(perf_counter_ns, time_ns)`` pair: of five brackets
    ``perf, wall, perf`` the tightest, its midpoint against its wall."""
    best = None
    for _ in range(5):
        a = time.perf_counter_ns()
        w = time.time_ns()
        b = time.perf_counter_ns()
        if best is None or b - a < best[0]:
            best = (b - a, (a + b) // 2, w)
    return best[1], best[2]


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
        #: the executor's current step, for spans whose site has none
        self.step = 0
        self._anchors: List[Tuple[int, int]] = [_anchor()]

    # ---------------- control ----------------
    def enable(self):
        global _last
        self._anchors = [_anchor()]
        self.enabled = True
        _last = self

    def disable(self):
        if self.enabled:
            self._anchors = self._anchors[:1] + [_anchor()]
        self.enabled = False

    def clear(self):
        with self._lock:
            self._spans.clear()
            self._dropped = 0
            self._anchors = [_anchor()]

    # ---------------- clock ----------------
    def _mapping(self) -> Tuple[int, int, float]:
        """``(p0, w0, rate)``: the start anchor and the wall clock's rate
        against ``perf_counter`` up to the stop anchor (while recording,
        up to now)."""
        anchors = self._anchors
        (p0, w0), (p1, w1) = anchors[0], (
            anchors[-1] if len(anchors) > 1 else _anchor())
        return p0, w0, (w1 - w0) / (p1 - p0) if p1 > p0 else 1.0

    def to_unix_ns(self, t: float) -> int:
        """A ``perf_counter`` stamp in Unix ns (``torch.profiler``'s event
        clock), interpolated between the start and stop anchors."""
        p0, w0, rate = self._mapping()
        return int(w0 + (t * 1e9 - p0) * rate)

    def clock(self) -> dict:
        """The anchors and the wall clock's drift against ``perf_counter``
        between them (ns over the interval, and parts per million)."""
        anchors = list(self._anchors)
        out = {"anchors": [list(a) for a in anchors], "drift_ns": None,
               "drift_ppm": None}
        if len(anchors) > 1:
            (p0, w0), (p1, w1) = anchors[0], anchors[-1]
            drift = (w1 - w0) - (p1 - p0)
            out["drift_ns"] = drift
            out["drift_ppm"] = 1e6 * drift / (p1 - p0) if p1 > p0 else None
        return out

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
                "dropped": self.dropped, "routes": routes,
                "clock": self.clock()}

    # ---------------- export ----------------
    def export_chrome(self, path: str) -> str:
        """Write the ring as Chrome trace-event JSON and return ``path``.
        One ``tid`` (track) per channel thread / executor / hint stream,
        named via ``ph="M"`` thread_name metadata. Timestamps are
        microseconds since the ``baseTimeNanoseconds`` that
        ``torch.profiler``'s ``export_chrome_trace`` uses, written too,
        so a profiler trace of the same window lines up with this one in
        Perfetto."""
        base = kineto_base_ns()
        p0, w0, rate = self._mapping()

        def us(t: float) -> float:
            return (w0 - base + (t * 1e9 - p0) * rate) / 1e3
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
                  "ts": us(t0)}
            if t1 is None:
                ev["ph"] = "i"
                ev["s"] = "t"                    # thread-scoped instant
            else:
                ev["ph"] = "X"
                ev["dur"] = max(0.0, us(t1) - us(t0))
            if args:
                ev["args"] = args
            events.append(ev)
        doc = {"traceEvents": events, "displayTimeUnit": "ms",
               "baseTimeNanoseconds": base,
               "otherData": {"dropped": self.dropped,
                             "capacity": self._capacity}}
        with open(path, "w") as f:
            json.dump(doc, f)
        return path
