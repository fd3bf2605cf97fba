"""The asynchronous transfer engine all offload traffic flows through.

Two scheduling levels, chosen so requests never deadlock on each other:

* **Request level** — `IOEngine.submit` enqueues a whole logical
  transfer (fetch layer-l params, spill a checkpoint tail, run one
  layer's optimizer segment) on a priority heap drained by a small
  worker pool. Priorities encode the critical path: a parameter fetch
  the GPU is about to block on always jumps ahead of a deferrable
  checkpoint spill.
* **Chunk level** — request bodies issue fixed-size chunk operations on
  the per-path channels (`submit_chunk`), one thread per SSD path, each
  with its own priority heap. Channels never wait on anything, so they
  always drain, so request workers always finish. Two request-on-request
  waits are permitted: a *gate* (α-delay ordering: a param fetch
  waiting on an optimizer flush — keep ``workers >= 2`` so the gating
  request can run while the gated one waits), and a *prefetch consume*
  (an optimizer flush using a ``PREFETCH_OPT`` hint's state reads) —
  legal because the consumer cancels a still-queued hint and only ever
  waits on a running-or-done request, whose body is itself wait-free.

Backpressure is a bounded in-flight byte budget charged at submit and
released at completion/cancellation. Cancellation is
best-effort-before-start (`IORequest.cancel`), which is exactly what a
schedule reset needs: queued prefetches die, a running one is drained.
:meth:`IOEngine.depth` exposes the live queue state (front heap,
per-route and per-path channel backlog, budget utilization) — the
signal the plan executor's backpressure-adaptive lookahead throttles
on.

Request/span lifecycle (what ``repro_torch.obs`` observes)
====================================================

Every request and chunk op walks the same four edges, and the tracer
hooks exactly those edges — so a trace is a complete account of where
each byte's time went:

    submit ──(queue-wait)──> start ──(transfer)──> settle
       │                       │                      │
       │ `t_submit` stamped    │ worker pops the      │ exactly-once
       │ (only while tracing   │ heap, wins           │ `_settle_once`
       │ is enabled)           │ `set_running_…`      │ accounting
       └── budget wait (front  └───────────────────────── completion,
           requests only; charged                         failure or
           against `inflight_bytes`)                      cancellation

When the shared :class:`repro_torch.obs.Tracer` is enabled, each worker
records TWO spans per executed request on its own track (= one Chrome
trace row per thread): a *queue-wait* span (``t_submit`` -> start; how
long the priority heap held it) and a *transfer* span (start ->
settle; how long the body ran), both tagged with route, priority
class, nbytes, the request's sequence number ``req`` (what a wait on
the request names) and — on channel threads — the SSD path index. A
cancelled-while-queued request records nothing (no bytes moved). With
the tracer disabled the only cost is one flag test per submit/run,
measured by the bench-smoke gate.
"""
from __future__ import annotations

import enum
import errno as _errno
import heapq
import itertools
import os
import threading
import time
from concurrent.futures import Future
from typing import Callable, Dict, List, Optional, Sequence

from repro_torch.io.bandwidth import BandwidthSimulator, PathBandwidthSimulator
from repro_torch.io.config import PATH_POLICIES, IOConfig
from repro_torch.io.integrity import IntegrityError
from repro_torch.io.staging import StagingPool
from repro_torch.obs.tracer import (CAT_IO_CHUNK, CAT_IO_QUEUE, CAT_IO_REQ,
                              CAT_IO_REQ_QUEUE, set_current_req,
                              set_thread_track)


class IOPriority(enum.IntEnum):
    """Lower value = more urgent (GreedySnake's critical-path order).

    ``KV`` (serving-time KV-cache block stream, ``repro_torch.serve``) sits
    right below the optimizer state: a late ``FETCH_KV`` stalls a whole
    request's next decode step — user-visible latency — but it must
    never starve the training-critical param/grad/opt streams when the
    two workloads share a device.

    ``ACT`` (SSDTrain-style activation spill/fetch) sits BELOW ckpt
    spills: the stream is opportunistic — it exists to soak up spare
    write bandwidth, and a late activation fetch only delays one
    micro-batch's backward, whereas a late checkpoint tail stalls the
    whole recompute pipeline."""
    PARAM_FETCH = 0
    INTER_LAYER_GRAD = 1
    OPTIMIZER_STATE = 2
    KV = 3
    CKPT_SPILL = 4
    ACT = 5


#: Consecutive chunk failures on one path before it is treated as
#: DRAINED: the "backlog"/"weighted" placement policies stop choosing
#: it for NEW chunks, and complete-chunk WRITES (whose authoritative
#: bytes the caller still holds) are rerouted to a survivor — both
#: pre-emptively in ``StripedFiles._place_for_write`` and reactively
#: via the per-chunk write-failover path. Reads of chunks already
#: placed there still run — and still fail loudly; their only copy is
#: on the dead device, so a silent reroute would return garbage.
#: One later success on the path zeroes the count (retry-recovered
#: transients therefore never accumulate toward the drain).
PATH_FAIL_DRAIN_THRESHOLD = 3

#: errno values classified as TRANSIENT: worth a bounded retry with
#: backoff, because the same op against the same device can legitimately
#: succeed a moment later. Everything else — EIO, ENOSPC, short reads,
#: injected dead-device faults — is permanent and propagates at once.
TRANSIENT_ERRNOS = frozenset(
    e for e in (_errno.EAGAIN, getattr(_errno, "EWOULDBLOCK", _errno.EAGAIN),
                _errno.EINTR, _errno.ETIMEDOUT, _errno.EBUSY,
                _errno.ENOBUFS))

#: Per-priority-class retry time budget (seconds of cumulative backoff
#: a chunk op may spend before its transient fault is escalated).
#: Critical-path classes give up fast — the executor blocks on them,
#: and a failed param fetch surfaces a loud, actionable error —
#: while the deferrable spill classes may ride out longer brownouts.
RETRY_TIMEOUT_S: Dict[int, float] = {
    IOPriority.PARAM_FETCH: 0.25,
    IOPriority.INTER_LAYER_GRAD: 0.25,
    IOPriority.OPTIMIZER_STATE: 0.5,
    IOPriority.KV: 0.25,
    IOPriority.CKPT_SPILL: 1.0,
    IOPriority.ACT: 1.0,
}


def is_transient(exc: BaseException) -> bool:
    """Transient-vs-permanent fault classification (see
    :data:`TRANSIENT_ERRNOS`). An explicit boolean ``transient``
    attribute on the exception overrides the errno heuristic — the
    chaos backend stamps it, and a real NVMe-oF transport could too.
    ``IntegrityError`` is transient for the retry round: a torn
    in-flight read heals on re-read, while bytes corrupted on the
    device keep mismatching until the budget is spent and the error
    propagates loudly."""
    t = getattr(exc, "transient", None)
    if t is not None:
        return bool(t)
    if isinstance(exc, IntegrityError):
        return True
    if isinstance(exc, OSError):
        return exc.errno in TRANSIENT_ERRNOS
    return False

#: Default priority for a given traffic-meter category.
CATEGORY_PRIORITY: Dict[str, IOPriority] = {
    "param": IOPriority.PARAM_FETCH,
    "inter_grad": IOPriority.INTER_LAYER_GRAD,
    "grad": IOPriority.INTER_LAYER_GRAD,
    "opt": IOPriority.OPTIMIZER_STATE,
    "kv": IOPriority.KV,
    "ckpt": IOPriority.CKPT_SPILL,
    "act": IOPriority.ACT,
}


class IORequest:
    """A scheduled transfer: callable + priority + accounting metadata.
    ``result()/cancel()/done()`` delegate to the underlying future."""

    __slots__ = ("priority", "seq", "category", "route", "nbytes", "fn",
                 "future", "_engine", "_accounted", "t_submit")

    def __init__(self, priority: int, seq: int, category: str, route: str,
                 nbytes: int, fn: Callable, engine: Optional["IOEngine"]):
        self.priority = int(priority)
        self.seq = seq
        self.category = category
        self.route = route
        self.nbytes = int(nbytes)
        self.fn = fn
        self.future: Future = Future()
        self._engine = engine
        self._accounted = False
        self.t_submit = 0.0     # stamped at submit ONLY while tracing

    def __lt__(self, other: "IORequest") -> bool:
        return (self.priority, self.seq) < (other.priority, other.seq)

    def result(self, timeout: Optional[float] = None):
        return self.future.result(timeout)

    def _settle_once(self) -> bool:
        """The budget/stat settlement must happen exactly once per
        request (cancel() on an already-cancelled Future returns True
        again, and completion follows a failed cancel)."""
        if self._accounted:
            return False
        self._accounted = True
        return True

    def cancel(self) -> bool:
        ok = self.future.cancel()
        if ok and self._engine is not None and self._settle_once():
            self._engine._on_cancelled(self)
        return ok

    def done(self) -> bool:
        return self.future.done()

    def running(self) -> bool:
        return self.future.running()

    def cancelled(self) -> bool:
        return self.future.cancelled()


class _PriorityWorkers:
    """N threads draining a priority heap of IORequests. When a tracer
    is attached each thread records queue-wait + execution spans on its
    own track (``path_index`` marks a single-thread path channel)."""

    def __init__(self, n: int, name: str, tracer=None,
                 path_index: Optional[int] = None):
        self._heap: List[IORequest] = []
        self._cv = threading.Condition()
        self._closed = False
        self._running = 0
        self._tracer = tracer
        self._path_index = path_index
        self._threads = [threading.Thread(target=self._run,
                                          name=f"{name}-{i}", daemon=True)
                         for i in range(n)]
        for t in self._threads:
            t.start()

    def submit(self, req: IORequest):
        with self._cv:
            if self._closed:
                raise RuntimeError("I/O engine is shut down")
            heapq.heappush(self._heap, req)
            self._cv.notify()

    def _run(self):
        set_thread_track(threading.current_thread().name)
        while True:
            with self._cv:
                while not self._heap and not self._closed:
                    self._cv.wait()
                if not self._heap:
                    return                       # closed and drained
                req = heapq.heappop(self._heap)
            if not req.future.set_running_or_notify_cancel():
                continue                         # cancelled while queued
            tr = self._tracer
            rec = tr is not None and tr.enabled and req.t_submit > 0.0
            if rec:
                set_current_req(req.seq)
                t_start = time.perf_counter()
            with self._cv:
                self._running += 1
            try:
                req.future.set_result(req.fn())
            except BaseException as e:           # propagate via the future
                req.future.set_exception(e)
            finally:
                with self._cv:
                    self._running -= 1
                if rec:
                    t_end = time.perf_counter()
                    self._record(tr, req, t_start, t_end)
                if req._engine is not None and req._settle_once():
                    req._engine._on_done(req)

    def _record(self, tr, req: IORequest, t_start: float, t_end: float):
        """Queue-wait + transfer spans for one executed request, on this
        worker thread's track."""
        track = threading.current_thread().name
        args = {"route": req.route, "nbytes": req.nbytes,
                "priority": IOPriority(req.priority).name, "req": req.seq}
        if self._path_index is None:             # front (request) pool
            name = req.category or "req"
            cat_q, cat_x = CAT_IO_REQ_QUEUE, CAT_IO_REQ
        else:                                    # path channel
            name = req.route or "chunk"
            cat_q, cat_x = CAT_IO_QUEUE, CAT_IO_CHUNK
            args["path"] = self._path_index
        tr.record(track, name + ":wait", cat_q, req.t_submit, t_start,
                  **args)
        tr.record(track, name, cat_x, t_start, t_end, **args)

    def shutdown(self, wait: bool = True):
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        if wait:
            for t in self._threads:
                t.join()


class IOEngine:
    """Priority-scheduled, budgeted, optionally bandwidth-paced transfers
    across one or more SSD paths. See the module docstring."""

    def __init__(self, config: Optional[IOConfig] = None, meter=None,
                 default_root: Optional[str] = None, tracer=None,
                 label: str = ""):
        # ``tracer``: a shared repro_torch.obs.Tracer (or None); ``label``
        # prefixes the worker thread names — the DP engine passes
        # "rank<r>-" so each rank's channels get distinct trace tracks.
        # The default is built HERE, not in the signature: a default
        # argument is evaluated once at class-definition time, so
        # `config: IOConfig = IOConfig()` would hand every
        # default-constructed engine the same IOConfig instance (and the
        # same `bandwidth` dict from its default_factory).
        if config is None:
            config = IOConfig()
        paths = config.resolved_paths(default_root) if (
            config.paths or default_root) else None
        if not paths:
            raise ValueError("IOConfig.paths must name at least one "
                             "directory (or pass default_root)")
        for p in paths:
            os.makedirs(p, exist_ok=True)
        self.config = config
        self.paths: Sequence[str] = list(paths)
        self.meter = meter
        self.tracer = tracer
        self.chunk_bytes = int(config.chunk_bytes)
        self.simulator = BandwidthSimulator(config.bandwidth)
        self.path_simulator = PathBandwidthSimulator(config.path_bandwidth,
                                                    len(self.paths))
        # chunk->path placement policy: mutable at runtime (the
        # autotuner's `apply_plan_config(path_policy=...)` actuates
        # here); StripedFiles consults it per write
        self.path_policy = config.path_policy
        self.staging = StagingPool(config.staging_buffers,
                                   max(self.chunk_bytes, 1 << 20))
        self._seq = itertools.count()
        self._front = _PriorityWorkers(max(1, config.workers),
                                       f"{label}io-req", tracer)
        self._channels = [_PriorityWorkers(1, f"{label}io-path{i}", tracer,
                                           path_index=i)
                          for i in range(len(self.paths))]
        self._budget = int(config.inflight_bytes)
        self._inflight = 0
        self._bp_cv = threading.Condition()
        # per-route bytes of chunk ops submitted but not yet finished —
        # the O(1) backlog signal the adaptive lookahead polls per hint
        # (depth() reports the same numbers without scanning heaps) —
        # plus the per-path counterparts (chunk backlog, cumulative
        # bytes/ops) that depth()/stats() report for path-level pacing
        self._backlog_lock = threading.Lock()
        self._route_backlog: Dict[str, int] = {}
        self._path_backlog = [0] * len(self.paths)
        self._path_backlog_bytes = [0] * len(self.paths)
        self._path_bytes = [0] * len(self.paths)
        self._path_chunk_ops = [0] * len(self.paths)
        # cumulative chunk bytes per route and split per (route, path) —
        # the split must SUM to the total exactly (placement moves
        # bytes between paths, never between routes; obs.reconcile
        # checks it)
        self._route_bytes: Dict[str, int] = {}
        self._route_path_bytes: Dict[str, List[int]] = {}
        # placement state: bytes the dynamic policies have assigned per
        # path (the deterministic "weighted" criterion and the backlog
        # tie-break), and consecutive failures per path (fault drain)
        self._placed_bytes = [0] * len(self.paths)
        self._path_failures = [0] * len(self.paths)
        # fault-recovery accounting: transient retries, write failovers
        # and CRC mismatches, split per path (index = path)
        self._path_retries = [0] * len(self.paths)
        self._retries = int(config.retries)
        self._retry_backoff = float(config.retry_backoff_s)
        self._closed = False
        self._stats_lock = threading.Lock()
        self._stats = {
            "submitted": 0, "completed": 0, "cancelled": 0, "chunk_ops": 0,
            "max_inflight_bytes": 0,
            "chunk_retries": 0, "chunk_failovers": 0, "integrity_errors": 0,
            "bytes_by_priority": {p.name: 0 for p in IOPriority},
        }

    # ---------------- request level ----------------
    def submit(self, fn: Callable, *, priority: IOPriority,
               category: str = "", route: str = "", nbytes: int = 0
               ) -> IORequest:
        """Schedule ``fn()`` with the given priority. Blocks while the
        in-flight byte budget is exhausted (backpressure); a request
        larger than the whole budget is admitted once the engine drains.
        """
        nbytes = int(nbytes)
        with self._bp_cv:
            while (not self._closed and self._inflight > 0
                   and self._inflight + nbytes > self._budget):
                self._bp_cv.wait()
            if self._closed:
                raise RuntimeError("I/O engine is shut down")
            self._inflight += nbytes
            with self._stats_lock:
                self._stats["submitted"] += 1
                self._stats["max_inflight_bytes"] = max(
                    self._stats["max_inflight_bytes"], self._inflight)
        req = IORequest(priority, next(self._seq), category, route, nbytes,
                        fn, self)
        tr = self.tracer
        if tr is not None and tr.enabled:
            req.t_submit = time.perf_counter()
        try:
            self._front.submit(req)
        except RuntimeError:
            self._release_bytes(nbytes)
            raise
        return req

    def _release_bytes(self, nbytes: int):
        with self._bp_cv:
            self._inflight -= nbytes
            self._bp_cv.notify_all()

    def _on_done(self, req: IORequest):
        self._release_bytes(req.nbytes)
        with self._stats_lock:
            self._stats["completed"] += 1
            self._stats["bytes_by_priority"][IOPriority(req.priority).name] \
                += req.nbytes

    def _on_cancelled(self, req: IORequest):
        self._release_bytes(req.nbytes)
        with self._stats_lock:
            self._stats["cancelled"] += 1

    # ---------------- chunk level ----------------
    def _with_retry(self, fn: Callable, priority: IOPriority,
                    path_index: int) -> Callable:
        """Wrap a chunk op in the bounded transient-retry loop: each
        attempt after a :func:`is_transient` fault backs off
        exponentially from ``retry_backoff_s``, bounded by BOTH the
        ``retries`` attempt budget and the op's priority-class time
        budget (:data:`RETRY_TIMEOUT_S`). The sleep runs on the owning
        path's channel thread — only the faulting device's channel
        stalls, which is the point. Permanent faults raise through
        unchanged on the first attempt."""
        budget = RETRY_TIMEOUT_S.get(priority, 0.5)

        def run():
            delay = self._retry_backoff
            spent = 0.0
            for attempt in range(self._retries + 1):
                try:
                    return fn()
                except BaseException as e:
                    if (attempt >= self._retries or not is_transient(e)
                            or spent + delay > budget):
                        raise
                    with self._stats_lock:
                        self._stats["chunk_retries"] += 1
                    with self._backlog_lock:
                        self._path_retries[path_index] += 1
                    if delay > 0:
                        time.sleep(delay)
                    spent += delay
                    delay = delay * 2 if delay > 0 else 0.0
        return run

    def submit_chunk(self, path_index: int, fn: Callable,
                     priority: IOPriority, route: str = "",
                     nbytes: int = 0) -> Future:
        """Enqueue one chunk operation on a path channel. Channels are
        leaf workers: ``fn`` must not wait on other engine work (the
        transient-retry sleeps are the one sanctioned stall — they hold
        only the faulting path's own channel). ``route``/``nbytes`` are
        accounting only — they feed the per-route and per-path
        channel-backlog counters (:meth:`route_backlog`, ``depth()``)
        the adaptive lookahead throttles on."""
        if self._retries > 0:
            fn = self._with_retry(fn, priority, path_index)
        req = IORequest(priority, next(self._seq), "", route, nbytes, fn,
                        None)
        tr = self.tracer
        if tr is not None and tr.enabled:
            req.t_submit = time.perf_counter()
        with self._stats_lock:
            self._stats["chunk_ops"] += 1
        with self._backlog_lock:
            if route and nbytes:
                self._route_backlog[route] = \
                    self._route_backlog.get(route, 0) + nbytes
                self._route_bytes[route] = \
                    self._route_bytes.get(route, 0) + nbytes
                per_path = self._route_path_bytes.get(route)
                if per_path is None:
                    per_path = self._route_path_bytes[route] = \
                        [0] * len(self.paths)
                per_path[path_index] += nbytes
            self._path_backlog[path_index] += 1
            self._path_backlog_bytes[path_index] += nbytes
            self._path_bytes[path_index] += nbytes
            self._path_chunk_ops[path_index] += 1

        def _done(f, route=route, nbytes=nbytes, pi=path_index):
            # fires on completion, failure, AND cancellation
            with self._backlog_lock:
                if route and nbytes:
                    self._route_backlog[route] -= nbytes
                self._path_backlog[pi] -= 1
                self._path_backlog_bytes[pi] -= nbytes
                if not f.cancelled():
                    if f.exception() is not None:
                        self._path_failures[pi] += 1
                    else:
                        self._path_failures[pi] = 0

        req.future.add_done_callback(_done)
        self._channels[path_index].submit(req)
        return req.future

    def route_backlog(self, route: str) -> int:
        """Bytes of chunk work submitted on ``route`` and not yet
        finished — the O(1) saturation signal (one lock, no heap
        scans; cheap enough to poll per plan op)."""
        with self._backlog_lock:
            return self._route_backlog.get(route, 0)

    def least_loaded_path(self) -> int:
        """Index of the path channel with the smallest queued chunk-byte
        backlog — MLP-Offload's multi-path idle-level rule as a live
        feedback signal (O(P) under one lock). Under the dynamic
        ``path_policy`` values this is no longer advisory:
        :meth:`choose_path` consumes the same backlog (rate-normalized)
        to place each newly written chunk; committed chunks keep their
        recorded placement until a full overwrite."""
        with self._backlog_lock:
            return min(range(len(self._path_backlog_bytes)),
                       key=self._path_backlog_bytes.__getitem__)

    def path_imbalance(self) -> float:
        """``max/mean`` of the per-path chunk-byte backlogs (1.0 =
        perfectly balanced; 0.0 = all paths idle). The steering-signal
        scalar the autotuner logs alongside each decision: a sustained
        imbalance says the current layout is not using some path's idle
        capacity — the ``"backlog"`` placement policy is the actuator
        that reclaims it."""
        with self._backlog_lock:
            total = sum(self._path_backlog_bytes)
            if not total:
                return 0.0
            return (max(self._path_backlog_bytes) * len(
                self._path_backlog_bytes)) / total

    # ---------------- chunk placement ----------------
    def set_path_policy(self, policy: str):
        """Switch the chunk->path placement policy at runtime (the
        autotuner's actuation point). Placement decisions already
        recorded in chunk-location tables are untouched — the policy
        governs where the NEXT full-chunk writes land."""
        if policy not in PATH_POLICIES:
            raise ValueError(
                f"path_policy {policy!r} not in {PATH_POLICIES}")
        self.path_policy = str(policy)

    def choose_path(self, nbytes: int = 0) -> int:
        """Pick the path for one chunk about to be written under the
        active dynamic policy (``StripedFiles`` calls this per placed
        chunk; meaningless under "static", which computes its layout).

        * "weighted" — deterministic rate-proportional spreading:
          argmin of (bytes this policy has placed there + nbytes) /
          path weight, weights from the per-path caps (all-equal when
          unpaced).
        * "backlog" — MLP-Offload's idle-level feedback: argmin of the
          path's queued-but-unfinished chunk bytes normalized by its
          rate weight (the time until the path drains), with the
          weighted criterion as the tie-break so an idle engine
          degrades to rate-proportional spreading.

        Paths at :data:`PATH_FAIL_DRAIN_THRESHOLD` consecutive chunk
        failures are excluded (a dead path fails fast and would
        otherwise look idle) unless every path is failing."""
        backlog = self.path_policy == "backlog"
        w = self.path_simulator.weights()
        with self._backlog_lock:
            live = [p for p in range(len(self.paths))
                    if self._path_failures[p] < PATH_FAIL_DRAIN_THRESHOLD]
            if not live:
                live = list(range(len(self.paths)))

            def score(p):
                placed = (self._placed_bytes[p] + nbytes) / w[p]
                if backlog:
                    return ((self._path_backlog_bytes[p] + nbytes) / w[p],
                            placed, p)
                return (placed, p)

            p = min(live, key=score)
            self._placed_bytes[p] += nbytes
            return p

    # ---------------- fault drain / failover ----------------
    def path_drained(self, path_index: int) -> bool:
        """True once ``path_index`` has failed
        :data:`PATH_FAIL_DRAIN_THRESHOLD` consecutive chunk ops —
        the signal ``StripedFiles`` consults to stop sending NEW
        complete-chunk writes there (any placement policy, static
        included: a dead device is a fault condition, not a layout
        choice)."""
        with self._backlog_lock:
            return (self._path_failures[path_index]
                    >= PATH_FAIL_DRAIN_THRESHOLD)

    def failover_path(self, exclude, nbytes: int = 0) -> Optional[int]:
        """Pick a surviving path for a chunk whose write just failed
        permanently on every path in ``exclude`` (or whose target is
        drained). Prefers live paths by the weighted/backlog score of
        :meth:`choose_path`; falls back to ANY non-excluded path when
        every survivor is also drained (the bytes must land somewhere,
        and a loud failure there beats silent data loss). Returns
        ``None`` only when ``exclude`` covers every path — the
        genuinely-irrecoverable case the caller escalates."""
        exclude = set(exclude)
        cands = [p for p in range(len(self.paths)) if p not in exclude]
        if not cands:
            return None
        w = self.path_simulator.weights()
        with self._backlog_lock:
            live = [p for p in cands
                    if self._path_failures[p] < PATH_FAIL_DRAIN_THRESHOLD]
            pool = live or cands
            p = min(pool, key=lambda q: (
                (self._path_backlog_bytes[q] + nbytes) / w[q],
                (self._placed_bytes[q] + nbytes) / w[q], q))
            self._placed_bytes[p] += nbytes
            return p

    def note_failover(self, from_path: int, to_path: int, name: str,
                      chunk: int):
        """Account one chunk write rerouted off a failing path;
        called by ``StripedFiles``."""
        with self._stats_lock:
            self._stats["chunk_failovers"] += 1

    def note_integrity_error(self, path_index: int, name: str, chunk: int):
        """Account one CRC mismatch; called by ``StripedFiles`` just
        before raising ``IntegrityError``."""
        with self._stats_lock:
            self._stats["integrity_errors"] += 1

    @property
    def inflight_bytes(self) -> int:
        with self._bp_cv:
            return self._inflight

    @property
    def budget_bytes(self) -> int:
        return self._budget

    # ---------------- accounting ----------------
    def depth(self) -> dict:
        """Thread-safe live queue-depth snapshot (introspection /
        diagnostics; the executor's per-hint saturation check uses the
        O(1) ``inflight_bytes`` / :meth:`route_backlog` accessors that
        feed the same numbers).

        Keys: ``queued`` (requests waiting in the front heap),
        ``running`` (request bodies currently executing),
        ``queued_by_priority`` (name -> count),
        ``queued_bytes_by_route`` (route -> request bytes waiting),
        ``channel_queued`` / ``channel_queued_bytes_by_route`` (chunk
        ops on the path channels, submitted and unfinished),
        ``channel_backlog_per_path`` / ``channel_backlog_bytes_per_path``
        (the same backlog split per SSD path, index = path),
        ``inflight_bytes`` / ``budget_bytes`` (the backpressure
        budget), and ``utilization`` (inflight / budget)."""
        with self._front._cv:
            heap = list(self._front._heap)
            running = self._front._running
        qbp = {p.name: 0 for p in IOPriority}
        qbr: Dict[str, int] = {}
        for req in heap:
            if req.future.cancelled():
                continue
            qbp[IOPriority(req.priority).name] += 1
            if req.route:
                qbr[req.route] = qbr.get(req.route, 0) + req.nbytes
        ch_n = 0
        for ch in self._channels:
            with ch._cv:
                ch_n += len(ch._heap)
        with self._backlog_lock:
            ch_bytes = {r: n for r, n in self._route_backlog.items() if n}
            path_backlog = list(self._path_backlog)
            path_backlog_bytes = list(self._path_backlog_bytes)
        with self._bp_cv:
            inflight = self._inflight
        return {
            "queued": len(heap), "running": running,
            "queued_by_priority": qbp, "queued_bytes_by_route": qbr,
            "channel_queued": ch_n,
            "channel_queued_bytes_by_route": ch_bytes,
            "channel_backlog_per_path": path_backlog,
            "channel_backlog_bytes_per_path": path_backlog_bytes,
            "inflight_bytes": inflight, "budget_bytes": self._budget,
            "utilization": inflight / self._budget if self._budget else 0.0,
        }

    def throttle(self, route: str, nbytes: int):
        """Pace a transfer on a simulated-bandwidth route (no-op when the
        route has no configured cap)."""
        self.simulator.throttle(route, nbytes)

    def throttle_path(self, path_index: int, nbytes: int):
        """Pace a chunk against its SSD path's simulated device cap
        (no-op without ``IOConfig.path_bandwidth``). Applied in
        addition to the route cap — a chunk pays every cap it
        crosses."""
        self.path_simulator.throttle(path_index, nbytes)

    def _collect_stats(self) -> dict:
        """Cumulative counters (the aggregate keys are stable; the
        ``*_per_path`` lists — index = path — are the per-path
        bandwidth evidence the placement policies and the perf model's
        snapshot ingestion read). ``chunk_bytes_by_route_per_path``
        splits each route's cumulative chunk bytes across paths;
        placement only moves bytes BETWEEN paths, so each list must sum
        exactly to the route's total (``obs.reconcile`` checks this)."""
        with self._stats_lock:
            s = {k: (dict(v) if isinstance(v, dict) else v)
                 for k, v in self._stats.items()}
        with self._backlog_lock:
            s["chunk_bytes_per_path"] = list(self._path_bytes)
            s["chunk_ops_per_path"] = list(self._path_chunk_ops)
            s["chunk_bytes_by_route"] = dict(self._route_bytes)
            s["chunk_bytes_by_route_per_path"] = {
                r: list(v) for r, v in self._route_path_bytes.items()}
            s["path_failures"] = list(self._path_failures)
            s["chunk_retries_per_path"] = list(self._path_retries)
            s["paths_drained"] = [f >= PATH_FAIL_DRAIN_THRESHOLD
                                  for f in self._path_failures]
        s["path_policy"] = self.path_policy
        s["path_bandwidth"] = [self.path_simulator.cap(i)
                               for i in range(len(self.paths))]
        s["inflight_bytes"] = self._inflight
        s["num_paths"] = len(self.paths)
        s["staging_oversized_allocs"] = self.staging.oversized_allocs
        return s

    def metrics_snapshot(self) -> dict:
        """Versioned counter snapshot — the one supported metrics
        surface (same schema as :func:`_collect_stats` plus a
        ``version`` key tracking ``repro_torch.obs.SNAPSHOT_VERSION``)."""
        from repro_torch.obs.registry import SNAPSHOT_VERSION
        return {"version": SNAPSHOT_VERSION, **self._collect_stats()}

    def stats(self) -> dict:
        """Deprecated alias for :func:`metrics_snapshot` (without the
        ``version`` key). Will be removed after the deprecation window
        noted in CHANGES.md."""
        import warnings
        warnings.warn(
            "IOEngine.stats() is deprecated; use metrics_snapshot()",
            DeprecationWarning, stacklevel=2)
        return self._collect_stats()

    # ---------------- lifecycle ----------------
    def shutdown(self, wait: bool = True):
        with self._bp_cv:
            self._closed = True
            self._bp_cv.notify_all()
        self._front.shutdown(wait)
        for ch in self._channels:
            ch.shutdown(wait)
