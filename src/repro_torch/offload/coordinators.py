"""The coordinators of GreedySnake §5 (as the reference's
``offload.coordinators``):

* ParameterCoordinator — per-layer (training) or per-unit (serving)
  params in tiered storage; two-stage prefetch (§4.2): the async engine
  request performs the SSD->host stage (scheduled by the plan's
  ``PREFETCH`` hints, after the layer's α gate), the host->device copy
  happens at consumption on the caller's thread, and the device copy is
  dropped after use. ``reset()`` cancels in-flight fetches via the I/O
  engine's cancellation API at a schedule boundary.
* InterLayerTensorCoordinator — activation checkpoints (forward) and
  inter-layer gradients (backward). Checkpoints are written to host and
  the (1-x_c) tail streamed to SSD; the forward consumer reads the host
  cache, after which the tail is dropped from host; the backward
  recompute re-reads the tail from SSD (asynchronously ahead of the
  consumer when a ``PREFETCH_CKPT`` hint fired). Inter-layer gradients
  stay on the host (never SSD). On a card both go through reused pinned
  host slots (:class:`repro_torch.offload.stores.PinnedPool`), copied on
  side streams without blocking the caller.
* OptimizerStepCoordinator — master/momentum/variance in tiered f32
  vectors and the host Adam (``CpuAdam``); the (1-α) fraction updates
  right after a layer's backward (an engine request, overlapped), the α
  fraction is flushed at the plan epilogue and gates the layer's next
  forward fetch (§4.4).
* ActivationCoordinator — the activation-spill stream: one layer
  forward's saved autograd tensors (:class:`LayerResiduals`) flattened to
  one byte payload, the ``x_act`` head kept in host memory and the tail
  streamed to SSD at ``IOPriority.ACT``; the tail is not cached, so every
  ``get`` re-reads it. Restored tensors come back on the device with
  their dtypes, shapes and strides, and backward runs from them.
* KVBlockCoordinator — the serving-time KV-cache block stream: an
  evicted request's per-unit cache tree is flattened to one byte payload
  through torch byte views, padded to a whole number of fixed-size blocks
  (``kv_blocks``), the ``x_host`` head blocks kept in host memory and the
  cold tail streamed to SSD at ``IOPriority.KV``. Resume restores every
  block bitwise onto the engine's device: the true payload length, the
  tree structure and each leaf's torch dtype and shape are kept in
  coordinator memory, so padding never leaks into the rebuilt tree.

Each counts lookahead hits/misses (``la_hits`` / ``la_misses``) and, when
the engine attaches its ``repro_torch.obs.Tracer`` (the ``tracer``
attribute), records one lifecycle span per hinted prefetch. While that
tracer records, each copy between the card and host memory is one
``copy.d2h`` / ``copy.h2d`` span (category ``copy``, with the metered
bytes and category, and ``pinned`` true for a copy through a pool
slot), the checkpoint tier's host-side assembly one ``host.stage`` span,
each host Adam update one ``adam.update`` span (``threads``: the pool's
threads that ran it) and each wait on an optimizer request one
``opt.wait`` span naming the request (``req``), all on the calling
thread's track (``obs.tracer.thread_track``). The optimizer coordinator
also counts its Adam calls, elements and busy seconds whether or not the
tracer records.

Device tensors cross to the host only on the caller's (executor's)
thread, before any ``engine.submit``: no engine worker touches CUDA.
"""
from __future__ import annotations

import math
import threading
import time
from concurrent.futures import CancelledError
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import tree
from repro_torch.io import IOEngine, IOPriority, IORequest
from repro_torch.obs.tracer import (CAT_COPY, CAT_HINT, CAT_OPT, CAT_SYNC,
                                    current_req, thread_track)
from repro_torch.offload.stores import (HostStore, PinnedPool, PoolSlot,
                                        SSDStore, TieredVector, TrafficMeter,
                                        host_cast, host_dtype, to_device,
                                        to_host)
from repro_torch.optim.cpu_adam import CpuAdam


def _hint_issue(coord, key):
    """Open a hint-lifecycle span: remember the issue time (only while
    the engine's tracer is recording — one flag test otherwise)."""
    tr = getattr(coord, "tracer", None)
    if tr is not None and tr.enabled:
        coord._hint_t[key] = time.perf_counter()


def _hint_settle(coord, stream: str, key, outcome: str):
    """Close a hint-lifecycle span with its outcome (hit / late /
    cancelled / unused). No-op for keys never opened (consumer-driven
    fetches, tracing off)."""
    t0 = coord._hint_t.pop(key, None)
    if t0 is None:
        return
    tr = getattr(coord, "tracer", None)
    if tr is None or not tr.enabled:
        return
    l, m = key if isinstance(key, tuple) else (key, -1)
    tr.record(f"hints/{stream}", f"{stream}:{outcome}", CAT_HINT,
              t0, time.perf_counter(), l=int(l), m=int(m), outcome=outcome)


def _stamp(tr) -> Optional[float]:
    """A span's start stamp while ``tr`` records, else None (one flag
    test)."""
    return time.perf_counter() if tr is not None and tr.enabled else None


def _copy_stamp(tr, device, l: int = -1, m: int = -1) -> Optional[float]:
    """A copy's start stamp while ``tr`` records, else None (one flag
    test). A copy between the card and pageable host memory first waits
    for the work queued on the stream before it, which is not the copy's
    own time: on the card the stream drains first, inside a ``copy.wait``
    span (category ``sync``), and the stamp is taken after it."""
    if tr is None or not tr.enabled:
        return None
    if torch.device(device).type == "cuda":
        t0 = time.perf_counter()
        torch.cuda.current_stream(device).synchronize()
        tr.record(thread_track(), "copy.wait", CAT_SYNC, t0,
                  time.perf_counter(), step=tr.step, l=int(l), m=int(m))
    return time.perf_counter()


def _copy_span(tr, t0: float, name: str, nbytes: int, l: int = -1,
               m: int = -1, **args):
    """Close a span of category ``copy`` opened at ``t0``: a copy between
    card and host memory (``copy.d2h`` / ``copy.h2d``) or its host-side
    staging (``host.stage``)."""
    tr.record(thread_track(), name, CAT_COPY, t0, time.perf_counter(),
              nbytes=int(nbytes), step=tr.step, l=int(l), m=int(m), **args)


def _xfer(meter: TrafficMeter, engine: IOEngine, category: str, route: str,
          nbytes: int, tr=None, t0: Optional[float] = None, l: int = -1,
          m: int = -1, pinned: bool = False):
    """Meter + (optionally) pace one device-side copy — the single place
    the meter.add/throttle pair lives for non-chunked transfers. Called
    right after the copy; ``t0`` (a :func:`_stamp` taken before it) also
    closes the copy's span with the metered bytes. ``pinned``: the copy
    went through a :class:`PinnedPool` slot (the checkpoint coordinator's
    pooled copies); every other copy uses pageable host memory."""
    if t0 is not None:
        _copy_span(tr, t0, "copy.d2h" if route == "gpu->cpu" else
                   "copy.h2d", nbytes, l, m, category=category, pinned=pinned)
    meter.add(category, route, nbytes)
    engine.throttle(route, nbytes)


def _cancel_or_drain(req: IORequest):
    """Dispose of a request whose result nobody wants: cancel it if
    still queued (no bytes moved), else drain it, swallowing its error
    — the caller has its own data path (fallback, unwind, teardown)."""
    if not req.cancel():
        try:
            req.result()
        except Exception:
            pass


def tree_to_bytes(t) -> Tuple[np.ndarray, tuple, list]:
    """One tree of tensors as (uint8 host buffer, treedef, leaf metas):
    every leaf's bytes through a ``uint8`` view, concatenated on its
    device and copied to the host once. Metas hold each leaf's torch
    dtype and shape."""
    leaves, treedef = tree.flatten(t)
    metas = [(x.dtype, tuple(x.shape)) for x in leaves]
    if not leaves:
        return np.zeros(0, np.uint8), treedef, metas
    flat = torch.cat([x.contiguous().reshape(-1).view(torch.uint8)
                      for x in leaves])
    return flat.cpu().numpy(), treedef, metas


def tree_from_bytes(buf: torch.Tensor, treedef, metas):
    """Inverse of :func:`tree_to_bytes`: one typed view of the ``uint8``
    tensor ``buf`` per leaf, on whatever device ``buf`` lies (a leaf whose
    byte offset is not a multiple of its item size is copied out
    first)."""
    leaves, off = [], 0
    for dt, shp in metas:
        nb = math.prod(shp) * dt.itemsize
        seg = buf[off:off + nb]
        if off % dt.itemsize:
            seg = seg.clone()
        leaves.append(seg.view(dt).reshape(shp))
        off += nb
    return tree.unflatten(treedef, leaves)


class ParameterCoordinator:
    """``dtype`` is the torch type of the vectors' elements on the device
    (the host holds bf16 as ``uint16`` bits; the serve engine's unit
    blobs are ``torch.uint8``)."""

    def __init__(self, vectors: List[TieredVector], meter: TrafficMeter,
                 engine: IOEngine, dtype: torch.dtype, device="cpu"):
        self.vectors = vectors
        self.meter = meter
        self.engine = engine
        self.device = torch.device(device)
        self.dtype = dtype
        self._futures: Dict[int, IORequest] = {}
        self._gate: Dict[int, Callable[[], None]] = {}
        self._gate_ready: Dict[int, Callable[[], bool]] = {}
        self.la_hits = 0        # get() found a completed prefetch
        self.la_misses = 0      # get() had to wait (or submit) the fetch
        self.tracer = None      # engine-attached repro_torch.obs.Tracer
        self._hint_t: Dict[int, float] = {}

    def set_gate(self, l: int, fn: Callable[[], None],
                 ready: Optional[Callable[[], bool]] = None):
        """Barrier that must complete before layer l's params are read
        (orders the α-delayed optimizer flush before the fetch).

        ``ready`` is the deadlock guard for HINTED fetches: it returns
        True only when waiting on the gate is bounded (the gating work is
        running or done, not still queued). A prefetch hint whose gate is
        not ready is skipped — otherwise gated fetch bodies, outranking
        the queued flushes, could occupy every request worker and leave
        none to run the flushes they wait on. A consumer-driven ``get``
        ignores ``ready``: the executor blocks instead of a worker."""
        self._gate[l] = fn
        if ready is not None:
            self._gate_ready[l] = ready

    def _fetch(self, l: int) -> np.ndarray:
        """SSD -> host stage only: wait the α gate, then assemble the host
        vector. The host -> device copy stays in :meth:`get` on the
        consumer thread."""
        gate = self._gate.pop(l, None)
        self._gate_ready.pop(l, None)
        if gate is not None:
            gate()
        return self.vectors[l].read()              # meters ssd->cpu

    def prefetch(self, l: int, consumer: bool = False):
        """Submit layer l's async host fetch. A HINT (``consumer=False``)
        is refused while l's gate is not ready (see :meth:`set_gate`);
        the consumer path always submits."""
        if not (0 <= l < len(self.vectors)) or l in self._futures:
            return
        if not consumer:
            ready = self._gate_ready.get(l)
            if l in self._gate and ready is not None and not ready():
                return
        v = self.vectors[l]
        self._futures[l] = self.engine.submit(
            lambda l=l: self._fetch(l), priority=IOPriority.PARAM_FETCH,
            category="param", route="ssd->cpu", nbytes=v.n * v.dtype.itemsize)
        if not consumer:
            _hint_issue(self, l)

    def get(self, l: int) -> torch.Tensor:
        """Layer l's vector on the device: waits for (or submits) the
        host fetch, then copies it host -> device."""
        if l not in self._futures:
            self.prefetch(l, consumer=True)
            self.la_misses += 1
        elif self._futures[l].done():
            self.la_hits += 1
            _hint_settle(self, "param", l, "hit")
        else:
            self.la_misses += 1
            _hint_settle(self, "param", l, "late")
        host_arr = self._futures.pop(l).result()
        t0 = _copy_stamp(self.tracer, self.device, l)
        dev = to_device(host_arr, self.dtype, host_arr.shape, self.device)
        _xfer(self.meter, self.engine, "param", "cpu->gpu", host_arr.nbytes,
              self.tracer, t0, l)
        return dev

    def reset(self):
        """Drop all outstanding prefetches at a schedule boundary:
        queued requests are cancelled before they touch storage; a
        running one is drained so its buffers settle. A drained
        request's ERROR is swallowed (``_cancel_or_drain``): nobody
        will consume these futures, and a failed prefetch left in
        ``_futures`` would re-raise a dead step's fault into the next
        step's ``get``."""
        for l, req in self._futures.items():
            _hint_settle(self, "param", l, "cancelled")
            _cancel_or_drain(req)
        self._futures.clear()

    def clear_gates(self):
        """Drop every armed α gate. Not part of :meth:`reset`: the
        ``RESET_PARAMS`` plan op calls ``reset()`` mid-step between
        waves, where the armed gates must survive to order the next
        wave's fetches after their optimizer tails. Only the executor's
        mid-step failure unwind clears them (the tails are abandoned
        with the step; a stale gate would re-raise its fault or deadlock
        the next step's first fetch)."""
        self._gate.clear()
        self._gate_ready.clear()


class InterLayerTensorCoordinator:
    """Checkpoints: (layer, mb) -> host head + SSD tail. ``x_cpu`` is the
    host-resident fraction of each checkpoint's elements; the tail
    beyond k goes to SSD. Tensors come back on ``device``.

    With a :class:`PinnedPool` attached (:meth:`attach_pool`; the engine
    attaches one when its device is a card) every payload the host holds
    whole goes through a pool slot: each inter-layer gradient, and each
    checkpoint when ``x_cpu`` keeps all of it on the host. Its copies
    start on the coordinator's two copy streams and return at once, the
    host head and (empty) tail are two views of the slot (no host
    staging), and the slot goes back to the pool at ``drop_ckpt``, after
    ``get_grad`` and on ``clear()``. A copy into a slot waits on the card
    for the last copy out of it, so a slot is never overwritten before
    its payload has left, and the host never reads a slot. A checkpoint
    with an SSD tail stays pageable: its slot would pin the whole payload
    until ``drop_ckpt``, where the plan holds only the head. A payload
    that finds no free slot takes the pageable path too (counted in
    ``pool_fallbacks``; ``pool_copies`` counts the pooled copies)."""

    def __init__(self, x_cpu: float, host: HostStore, ssd: SSDStore,
                 meter: TrafficMeter, engine: IOEngine, device="cpu"):
        self.x = x_cpu
        self.host = host
        self.ssd = ssd
        self.meter = meter
        self.engine = engine
        self.device = torch.device(device)
        self._pending: Dict[Tuple[str, int, int], IORequest] = {}
        self._shapes: Dict[Tuple[str, int, int], tuple] = {}
        self._device_kept: Dict[Tuple[int, int], torch.Tensor] = {}
        self._prefetched: Dict[Tuple[int, int], IORequest] = {}  # bwd tails
        self.la_hits = 0        # bwd tail was prefetched and had landed
        self.la_misses = 0      # bwd tail came off the SSD synchronously
        self.tracer = None      # engine-attached repro_torch.obs.Tracer
        self._hint_t: Dict[Tuple[int, int], float] = {}
        self.pool: Optional[PinnedPool] = None
        self._slots: Dict[Tuple[str, int, int], PoolSlot] = {}
        self._d2h = self._h2d = None     # the copy streams (card only)
        self.pool_copies = 0             # copies through a pool slot
        self.pool_fallbacks = 0          # payloads that found no slot

    def attach_pool(self, pool: Optional[PinnedPool]):
        """Copy every later payload through ``pool`` (None: the pageable
        path). Only while no payload holds a slot (after ``clear()``)."""
        if self._slots:
            raise RuntimeError(f"{len(self._slots)} payloads still hold "
                               "slots of the attached pool")
        self.pool = pool
        if pool is not None and self.device.type == "cuda" \
                and self._d2h is None:
            self._d2h = torch.cuda.Stream(self.device)
            self._h2d = torch.cuda.Stream(self.device)

    def _key(self, kind: str, l: int, m: int) -> str:
        return f"{kind}:{l}:{m}"

    def _dev(self, arr: np.ndarray, key) -> torch.Tensor:
        shape, dtype = self._shapes[key]
        return to_device(arr, dtype, shape, self.device)

    # ---- pool slots ----
    def _to_slot(self, key, t: torch.Tensor, category: str
                 ) -> Optional[np.ndarray]:
        """Start the device -> host copy of ``t`` into a free slot, held
        under ``key``, without waiting for it. Returns the payload's host
        view (for the host's accounting: it is read only by the card), or
        None when there is no pool or no slot for it."""
        pool = self.pool
        if pool is None:
            return None
        nbytes = t.numel() * t.element_size()
        slot = pool.acquire() if nbytes <= pool.size else None
        if slot is None:
            self.pool_fallbacks += 1
            return None
        self._slots[key] = slot
        tr = self.tracer
        t0 = _stamp(tr)
        src = t.detach().reshape(-1)
        dst = slot.t[:nbytes].view(t.dtype)
        if self._d2h is None:
            dst.copy_(src)
        else:
            s = self._d2h
            # after the work that produced ``t`` and the last copy out of
            # the slot; the allocator keeps ``t``'s storage until the copy
            # has read it
            s.wait_stream(torch.cuda.current_stream(t.device))
            if slot.h2d is not None:
                s.wait_event(slot.h2d)
            with torch.cuda.stream(s):
                dst.copy_(src, non_blocking=True)
            src.record_stream(s)
            if slot.d2h is None:
                slot.d2h = torch.cuda.Event()
            slot.d2h.record(s)
        self.pool_copies += 1
        _xfer(self.meter, self.engine, category, "gpu->cpu", nbytes, tr, t0,
              key[1], key[2], pinned=True)
        return slot.t[:nbytes].numpy().view(host_dtype(t.dtype))

    def _from_slot(self, key, category: str) -> torch.Tensor:
        """Start the host -> device copy of the payload in ``key``'s slot
        without waiting for it; the current stream waits for it on the
        card before its next op."""
        slot = self._slots[key]
        shape, dtype = self._shapes[key]
        n = math.prod(shape)
        nbytes = n * dtype.itemsize
        tr = self.tracer
        t0 = _stamp(tr)
        src = slot.t[:nbytes].view(dtype)
        if self._h2d is None:
            dev = src.clone()           # its own storage: the slot is reused
        else:
            s = self._h2d
            cur = torch.cuda.current_stream(self.device)
            if slot.d2h is not None:
                s.wait_event(slot.d2h)
            with torch.cuda.stream(s):
                dev = torch.empty(n, dtype=dtype, device=self.device)
                dev.copy_(src, non_blocking=True)
            if slot.h2d is None:
                slot.h2d = torch.cuda.Event()
            slot.h2d.record(s)
            cur.wait_event(slot.h2d)
            dev.record_stream(cur)
        self.pool_copies += 1
        _xfer(self.meter, self.engine, category, "cpu->gpu", nbytes, tr, t0,
              key[1], key[2], pinned=True)
        return dev.view(shape)

    def _release(self, key):
        """Give ``key``'s slot back to the pool (a no-op if it holds none);
        the next copy into it waits on the card for this one's copies."""
        slot = self._slots.pop(key, None)
        if slot is not None:
            self.pool.release(slot)

    # ---- forward checkpoints ----
    def put_ckpt(self, l: int, m: int, y_dev: torch.Tensor,
                 keep_on_device: bool = False):
        """Offload layer-l input checkpoint for micro-batch m."""
        if keep_on_device:
            self._device_kept[(l, m)] = y_dev
        tr = self.tracer
        k = int(round(self.x * y_dev.numel()))
        # only a payload the host keeps whole goes through a slot
        arr = (self._to_slot(("c", l, m), y_dev, "ckpt")
               if k == y_dev.numel() else None)
        pooled = arr is not None
        if not pooled:
            t0 = _copy_stamp(tr, y_dev.device, l, m)
            arr = to_host(y_dev).reshape(-1)
            _xfer(self.meter, self.engine, "ckpt", "gpu->cpu", arr.nbytes,
                  tr, t0, l, m)
        self._shapes[("c", l, m)] = (tuple(y_dev.shape), y_dev.dtype)
        name = self._key("c", l, m)
        if pooled:
            # the whole payload is the head, in the slot: nothing to stage
            self.host.put(name + ":h", arr[:k])
            self.host.put(name + ":tail", arr[k:])
        else:
            t0 = _stamp(tr)
            self.host.put(name + ":h", arr[:k].copy())
            # the tail stays cached on the host until the forward
            # consumes it
            self.host.put(name + ":tail", arr[k:].copy())
            if t0 is not None:
                _copy_span(tr, t0, "host.stage", arr.nbytes, l, m,
                           what="put_ckpt")
        if k < arr.size:
            old = self._pending.pop(("c", l, m), None)
            if old is not None:
                old.result()    # never two in-flight spills of one name
            # spill via the staging pool: lowest priority, cancellable
            self._pending[("c", l, m)] = self.ssd.write_async(
                name + ":s", arr[k:], "ckpt")

    def get_ckpt_fwd(self, l: int, m: int) -> torch.Tensor:
        """Next-layer forward input: device-kept or host cache (no SSD
        read). Drops the host tail afterwards (reclaimed, §4.4)."""
        if (l, m) in self._device_kept:
            return self._device_kept.pop((l, m))
        # §4.2 device-slot discipline: a kept boundary checkpoint is only
        # useful to the boundary's FIRST consumer; a consumer for another
        # micro-batch means the order was perturbed, so the kept copy is
        # evicted (its host cache exists) and re-read like any other.
        for k in [k for k in self._device_kept if k[0] == l]:
            del self._device_kept[k]
        name = self._key("c", l, m)
        head = self.host.get(name + ":h")
        tail = self.host.pop(name + ":tail")   # consume host cache
        if ("c", l, m) in self._slots:
            # the whole payload is in the slot
            return self._from_slot(("c", l, m), "ckpt")
        tr = self.tracer
        t0 = _stamp(tr)
        arr = np.concatenate([head, tail])
        if t0 is not None:
            _copy_span(tr, t0, "host.stage", arr.nbytes, l, m,
                       what="get_ckpt_fwd")
        t0 = _copy_stamp(tr, self.device, l, m)
        dev = self._dev(arr, ("c", l, m))
        _xfer(self.meter, self.engine, "ckpt", "cpu->gpu", arr.nbytes, tr, t0,
              l, m)
        return dev

    def prefetch_bwd(self, l: int, m: int):
        """``PREFETCH_CKPT`` hint: start the backward tail's SSD re-read
        now (ckpt priority). No-op when the payload cannot need an SSD
        read — unknown key, host-cached tail, fully host-resident head —
        or when the spill itself is still in flight (a request body must
        never wait on another request)."""
        key = (l, m)
        if key in self._prefetched or ("c", l, m) not in self._shapes:
            return
        name = self._key("c", l, m)
        if name + ":tail" in self.host or name + ":h" not in self.host:
            return
        head = self.host.get(name + ":h")
        n = math.prod(self._shapes[("c", l, m)][0])
        if head.size >= n:
            return
        wr = self._pending.get(("c", l, m))
        if wr is not None and not wr.done():
            return
        self._prefetched[key] = self.engine.submit(
            lambda: self.ssd.read(name + ":s", "ckpt"),
            priority=IOPriority.CKPT_SPILL, category="ckpt",
            route="ssd->cpu",
            nbytes=(n - head.size) * head.dtype.itemsize)
        _hint_issue(self, key)

    def get_ckpt_bwd(self, l: int, m: int) -> torch.Tensor:
        """Backward recompute input: host head + SSD tail (prefetched by
        a ``PREFETCH_CKPT`` hint when the lookahead pass placed one)."""
        self._device_kept.pop((l, m), None)
        name = self._key("c", l, m)
        req = self._pending.pop(("c", l, m), None)
        if req is not None:
            req.result()
        pre = self._prefetched.pop((l, m), None)
        head = self.host.get(name + ":h")
        n = math.prod(self._shapes[("c", l, m)][0])
        if head.size < n:
            if name + ":tail" in self.host:      # never trimmed (x=1 case)
                tail = self.host.get(name + ":tail")
            elif pre is not None:
                hit = pre.done()     # evaluate once: it can flip mid-read
                self.la_hits += hit
                self.la_misses += not hit
                _hint_settle(self, "ckpt", (l, m), "hit" if hit else "late")
                tail = pre.result()
                pre = None
            else:
                self.la_misses += 1
                tail = self.ssd.read(name + ":s", "ckpt")
            t0 = _stamp(self.tracer)
            arr = np.concatenate([head, tail])
            if t0 is not None:
                _copy_span(self.tracer, t0, "host.stage", arr.nbytes, l, m,
                           what="get_ckpt_bwd")
        else:
            arr = head
        if pre is not None:          # prefetched but unused (host-cached)
            _hint_settle(self, "ckpt", (l, m), "unused")
            _cancel_or_drain(pre)
        if ("c", l, m) in self._slots:
            return self._from_slot(("c", l, m), "ckpt")
        t0 = _copy_stamp(self.tracer, self.device, l, m)
        dev = self._dev(arr, ("c", l, m))
        _xfer(self.meter, self.engine, "ckpt", "cpu->gpu", arr.nbytes,
              self.tracer, t0, l, m)
        return dev

    def wait_pending(self):
        """Drain all outstanding checkpoint spills (engine teardown)."""
        for req in list(self._pending.values()):
            try:
                req.result()
            except CancelledError:
                pass
        self._pending.clear()

    def clear(self):
        """Abandon every checkpoint / inter-layer gradient this
        coordinator tracks: release device-kept tensors, cancel or drain
        in-flight spills (swallowing their errors — the caller is already
        unwinding), and drop the host-resident pieces and their pool
        slots. The plan executor's mid-step failure path."""
        self._device_kept.clear()
        for req in list(self._pending.values()):
            _cancel_or_drain(req)
        self._pending.clear()
        for key, req in list(self._prefetched.items()):
            _hint_settle(self, "ckpt", key, "cancelled")
            _cancel_or_drain(req)
        self._prefetched.clear()
        for kind, l, m in list(self._shapes):
            name = self._key(kind, l, m)
            keys = ([name + ":h", name + ":tail"] if kind == "c"
                    else [name])
            for key in keys:
                if key in self.host:
                    self.host.pop(key)
        self._shapes.clear()
        for key in list(self._slots):
            self._release(key)

    def drop_ckpt(self, l: int, m: int):
        # A ckpt consumed only via get_ckpt_fwd (the head layer) still has
        # its SSD spill in flight: drain it so no orphan write can race a
        # next-step spill of the same name and counters stay deterministic.
        self._device_kept.pop((l, m), None)
        pre = self._prefetched.pop((l, m), None)
        if pre is not None:
            _hint_settle(self, "ckpt", (l, m), "cancelled")
            _cancel_or_drain(pre)
        req = self._pending.pop(("c", l, m), None)
        if req is not None:
            req.result()
        name = self._key("c", l, m)
        for key in (name + ":h", name + ":tail"):
            if key in self.host:
                self.host.pop(key)
        self._release(("c", l, m))

    # ---- inter-layer gradients (backward; host only, §4.3) ----
    def put_grad(self, l: int, m: int, dx_dev: torch.Tensor,
                 keep_on_device: bool = False):
        if keep_on_device:
            self._device_kept[(-l - 1, m)] = dx_dev
            return
        self._spill_grad(l, m, dx_dev)

    def _spill_grad(self, l: int, m: int, dx_dev: torch.Tensor):
        arr = self._to_slot(("g", l, m), dx_dev, "inter_grad")
        if arr is not None:
            arr = arr.reshape(dx_dev.shape)
        else:
            t0 = _copy_stamp(self.tracer, dx_dev.device, l, m)
            arr = to_host(dx_dev)
            _xfer(self.meter, self.engine, "inter_grad", "gpu->cpu",
                  arr.nbytes, self.tracer, t0, l, m)
        self._shapes[("g", l, m)] = (tuple(dx_dev.shape), dx_dev.dtype)
        self.host.put(self._key("g", l, m), arr)

    def get_grad(self, l: int, m: int) -> torch.Tensor:
        if (-l - 1, m) in self._device_kept:
            return self._device_kept.pop((-l - 1, m))
        # Out-of-order consumer: a kept inter-layer gradient was never
        # written to host (that is the whole saving), so losing the
        # device slot forces the spill the alternating order §4.2 avoids.
        for k in [k for k in self._device_kept if k[0] == -l - 1]:
            self._spill_grad(l, k[1], self._device_kept.pop(k))
        arr = self.host.pop(self._key("g", l, m))
        if ("g", l, m) in self._slots:
            dev = self._from_slot(("g", l, m), "inter_grad")
            self._release(("g", l, m))
            return dev
        t0 = _copy_stamp(self.tracer, self.device, l, m)
        dev = self._dev(arr, ("g", l, m))
        _xfer(self.meter, self.engine, "inter_grad", "cpu->gpu", arr.nbytes,
              self.tracer, t0, l, m)
        return dev


class _LateTail:
    """One layer's α-tail flush, kept until its writes have landed: the
    retained gradient tail, the ``prefetch_late`` hint it may consume and,
    once Adam has run, the updated (master, m, v) segments, so a retry
    rewrites the same values and never re-runs the update on partly
    written state."""

    __slots__ = ("g", "step", "pre", "segs")

    def __init__(self, g: np.ndarray, step: int, pre: Optional[IORequest]):
        self.g, self.step, self.pre, self.segs = g, step, pre, None


class OptimizerStepCoordinator:
    """Per-layer Adam over tiered f32 state vectors with α-delay. Each
    layer's update runs as an OPTIMIZER_STATE-priority engine request:
    its tiered-vector reads/writes become chunked channel ops that yield
    to parameter fetches on the same SSD paths. The low-precision copy
    written back to the parameter tier is ``param_dtype`` (a torch type;
    bf16 rounds to nearest even on the host, :func:`host_cast`).

    An α-tail flush outlives the step that submits it (the plan's
    epilogue waits on none), so its faults are settled where it is waited
    on — at the next step's α gate or in :meth:`finish`'s waits — and
    never re-raise a finished step's fault as the next step's: a failed
    ``prefetch_late`` hint is a miss (the flush reads the tail itself),
    and a failed flush is retried once from its retained segments
    (:class:`_LateTail`) by :meth:`wait_late`. Only a failed retry
    raises, in the step that waits on it. The reference re-raises the
    first failure at the next step's gate."""

    def __init__(self, masters: List[TieredVector], ms: List[TieredVector],
                 vs: List[TieredVector], params: List[TieredVector],
                 host: HostStore, meter: TrafficMeter,
                 engine: IOEngine, adam: CpuAdam, alpha: float,
                 param_dtype: torch.dtype = torch.bfloat16):
        self.masters, self.ms, self.vs = masters, ms, vs
        self.params = params
        self.host = host
        self.meter = meter
        self.engine = engine
        self.adam = adam
        self.alpha = alpha
        self.param_dtype = param_dtype
        self._early_futs: Dict[int, IORequest] = {}
        self._late_futs: Dict[int, IORequest] = {}
        self._late_pre: Dict[int, IORequest] = {}   # PREFETCH_OPT reads
        self._late_tails: Dict[int, _LateTail] = {}  # until writes land
        self.la_hits = 0        # flush_late consumed a landed prefetch
        self.la_misses = 0      # flush_late read the α-tail itself
        self.tracer = None      # engine-attached repro_torch.obs.Tracer
        self._hint_t: Dict[int, float] = {}
        # host Adam calls, elements and busy seconds (always counted)
        self._adam_lock = threading.Lock()
        self.adam_calls = 0
        self.adam_params = 0
        self.adam_busy_s = 0.0

    def reset_adam_stats(self):
        with self._adam_lock:
            self.adam_calls = self.adam_params = 0
            self.adam_busy_s = 0.0

    def _update(self, seg: str, l: int, step: int, n: int, *args):
        """One host Adam update of ``n`` elements, ``self.adam.update(*args)``,
        counted, and spanned on the calling worker's track while tracing."""
        t0 = time.perf_counter()
        self.adam.update(*args)
        t1 = time.perf_counter()
        with self._adam_lock:
            self.adam_calls += 1
            self.adam_params += n
            self.adam_busy_s += t1 - t0
        tr = self.tracer
        if tr is not None and tr.enabled:
            tr.record(thread_track(), "adam.update", CAT_OPT, t0, t1,
                      seg=seg, params=int(n), l=l, step=step,
                      threads=self.adam.last_threads, req=current_req())

    def _wait_span(self, t0: float, kind: str, req: IORequest, l: int,
                   step: int):
        """Close an ``opt.wait`` span on ``req``, opened at ``t0``."""
        self.tracer.record(thread_track(), "opt.wait", CAT_OPT, t0,
                           time.perf_counter(), kind=kind, req=req.seq, l=l,
                           step=step)

    def _k_early(self, l: int) -> int:
        return int(round((1.0 - self.alpha) * self.masters[l].n))

    def prefetch_late(self, l: int):
        """``PREFETCH_OPT`` hint: start layer l's α-tail state reads
        (master/m/v of [k_early, n)) now, so the next ``flush_late`` only
        runs the Adam segment and the writes. Value-safe whenever the
        previous flush of l has completed (the α gate orders it before
        l's forward fetch) — the concurrent early segment only writes the
        disjoint [0, k_early) ranges. Moves the reads earlier, never
        changes them."""
        if l in self._late_pre:
            return
        n = self.masters[l].n
        k = self._k_early(l)
        if k >= n:
            return

        def work():
            return (self.masters[l].read_range(k, n),
                    self.ms[l].read_range(k, n),
                    self.vs[l].read_range(k, n))

        self._late_pre[l] = self.engine.submit(
            work, priority=IOPriority.OPTIMIZER_STATE, category="opt",
            route="ssd->cpu", nbytes=3 * (n - k) * 4)
        _hint_issue(self, l)

    def submit_early(self, l: int, g_dev: torch.Tensor, step: int):
        """After layer l's backward: copy the grads to the host (here, on
        the caller's thread), update the (1-α) fraction in an engine
        request, retain the α fraction's grads on the host. The α tail is
        retained here, on the caller's thread, so the host store's
        residency (and its peak) does not depend on when a worker runs
        the request; it is a view, since the request holds all of ``g``
        until ``flush_late`` takes both."""
        t0 = _copy_stamp(self.tracer, g_dev.device, l)
        g = g_dev.detach().float().cpu().numpy()
        _xfer(self.meter, self.engine, "grad", "gpu->cpu", g.nbytes,
              self.tracer, t0, l)
        k = self._k_early(l)
        if k < self.masters[l].n:
            self.host.put(f"pending_grad:{l}", g[k:])

        def work():
            if k > 0:
                mast = self.masters[l].read_range(0, k)
                m_ = self.ms[l].read_range(0, k)
                v_ = self.vs[l].read_range(0, k)
                self._update("early", l, step, k, mast, m_, v_, g[:k], step)
                self.masters[l].write_seg(mast, 0)
                self.ms[l].write_seg(m_, 0)
                self.vs[l].write_seg(v_, 0)
                self.params[l].write_seg(host_cast(mast, self.param_dtype), 0)

        self._early_futs[l] = self.engine.submit(
            work, priority=IOPriority.OPTIMIZER_STATE, category="opt",
            route="cpu->ssd", nbytes=g.nbytes)

    def flush_late(self, l: int, step: int):
        """Flush the remaining α fraction (gate-ordered before layer l's
        next forward fetch). Consumes a ``prefetch_late`` hint's state
        reads when one landed; a still-queued hint is cancelled (no bytes
        moved) and the flush reads the tail itself, so the byte counters
        are hint-invariant either way."""
        f = self._early_futs.pop(l, None)
        if f is not None:
            t0 = _stamp(self.tracer)
            f.result()
            if t0 is not None:
                self._wait_span(t0, "early", f, l, step)
        pre = self._late_pre.pop(l, None)
        n = self.masters[l].n
        k = self._k_early(l)
        key = f"pending_grad:{l}"
        if k >= n or key not in self.host:
            if pre is not None:
                _hint_settle(self, "opt", l, "unused")
                _cancel_or_drain(pre)
            return
        g_tail = self.host.pop(key)
        if pre is not None:
            if pre.done():
                self.la_hits += 1
                _hint_settle(self, "opt", l, "hit")
            elif pre.cancel():
                pre = None           # never started: read synchronously
                self.la_misses += 1
                _hint_settle(self, "opt", l, "cancelled")
            else:
                self.la_misses += 1  # running: its bytes are in flight
                _hint_settle(self, "opt", l, "late")
        else:
            self.la_misses += 1
        tail = _LateTail(g_tail, step, pre)
        self._late_tails[l] = tail
        self._late_futs[l] = self.engine.submit(
            lambda: self._run_tail(l, tail),
            priority=IOPriority.OPTIMIZER_STATE, category="opt",
            route="cpu->ssd", nbytes=g_tail.nbytes)

    def _run_tail(self, l: int, tail: _LateTail):
        """Layer l's α-tail update: read the tail's state (from the hint
        when it landed), run Adam once, write the segments. A retry after
        a failure rewrites the retained segments, or reads again when the
        reads were what failed."""
        n = self.masters[l].n
        k = self._k_early(l)
        if tail.segs is None:
            segs, pre, tail.pre = None, tail.pre, None
            if pre is not None:
                # running-or-done by construction (a queued hint was
                # cancelled in flush_late), so this wait is bounded; a
                # failed hint is a miss, never the flush's fault
                try:
                    segs = pre.result()
                except Exception:
                    segs = None
            if segs is None:
                segs = (self.masters[l].read_range(k, n),
                        self.ms[l].read_range(k, n),
                        self.vs[l].read_range(k, n))
            self._update("late", l, tail.step, n - k, *segs, tail.g,
                         tail.step)
            tail.segs = segs
        mast, m_, v_ = tail.segs
        self.masters[l].write_seg(mast, k)
        self.ms[l].write_seg(m_, k)
        self.vs[l].write_seg(v_, k)
        self.params[l].write_seg(host_cast(mast, self.param_dtype), k)

    def wait_late(self, l: int):
        """Wait for layer l's α-tail flush. A flush that failed is retried
        once, here, from its retained segments; only a failed retry
        raises. Either way nothing of the tail is retained after."""
        f = self._late_futs.pop(l, None)
        if f is None:
            return
        tail = self._late_tails.pop(l, None)
        t0 = _stamp(self.tracer)
        try:
            f.result()
        except Exception:
            if tail is None:
                raise
            self._run_tail(l, tail)
        if t0 is not None:
            self._wait_span(t0, "late", f, l,
                            tail.step if tail is not None else self.tracer.step)

    def late_settled(self, l: int) -> bool:
        """Is waiting on layer l's late flush bounded right now — no flush
        outstanding, or its request already running/done (never still
        queued)? The α-gate readiness probe for hinted fetches."""
        f = self._late_futs.get(l)
        return f is None or f.done() or f.running()

    def wait_all(self):
        for l, f in list(self._late_pre.items()):
            _hint_settle(self, "opt", l, "cancelled")
            _cancel_or_drain(f)     # an orphaned hint's error is moot
        self._late_pre.clear()
        for l, f in list(self._early_futs.items()):
            t0 = _stamp(self.tracer)
            f.result()
            if t0 is not None:
                self._wait_span(t0, "all", f, l, self.tracer.step)
        self._early_futs.clear()
        for l in list(self._late_futs):
            self.wait_late(l)

    def clear(self):
        """Abandon every outstanding flush after a failed step:
        cancel-or-drain all futures and drop retained α-tail gradients,
        so the next step cannot consume a stale ``pending_grad`` or trip
        over a failed flush via the α gate. Never raises. The completed
        prefix of the in-place Adam update stays applied — a failed step
        is re-run from a checkpoint, not resumed."""
        for d in (self._late_pre, self._early_futs, self._late_futs):
            for f in list(d.values()):
                _cancel_or_drain(f)
            d.clear()
        self._late_tails.clear()
        self._hint_t.clear()
        for l in range(len(self.masters)):
            key = f"pending_grad:{l}"
            if key in self.host:
                self.host.pop(key)


def _dense_strides(shape, stride) -> bool:
    """Whether ``stride`` lays ``shape``'s elements out without gaps or
    overlaps (some permutation of a contiguous layout): only such
    layouts can be rebuilt by ``empty_strided`` + ``copy_``."""
    dims = sorted((st, n) for n, st in zip(shape, stride) if n != 1)
    want = 1
    for st, n in dims:
        if st != want:
            return False
        want *= n
    return True


class LayerResiduals:
    """One layer forward's autograd graph, with every tensor autograd
    saved for its backward held outside the graph.

    The forward runs under ``torch.autograd.graph.saved_tensors_hooks``
    whose pack hook appends the tensor to ``saved`` and returns its index;
    the unpack hook returns ``saved[index]``. The graph itself keeps only
    the indices, so swapping the entries of ``saved`` (spill: out to the
    host, back on ``get``) changes where backward reads its inputs without
    touching the graph. ``saved`` is that same list object for the
    residuals' whole life (filled and emptied in place, never rebound),
    and holds detached tensors, so it never leads back to the graph. ``out_edge`` / ``in_edges`` are the gradient
    edges of the layer output and of its leaves ``(p, x)``; the leaves'
    own storage is released with :meth:`release` (autograd's
    accumulate-grad nodes hold the leaf tensors, so without that the
    layer's parameter buffer and input would stay on the device for as
    long as the graph)."""

    def __init__(self, saved: list):
        self.saved = saved
        self.out_edge = None
        self.aux_edge = None
        self.in_edges = ()
        self._leaves = ()
        self._index: Optional[List[int]] = None

    def bind(self, y: torch.Tensor, leaves: Tuple[torch.Tensor, ...],
             aux: Optional[torch.Tensor] = None):
        """Record the gradient edges of the forward's output and leaves,
        and of its scalar loss term ``aux`` (a MoE layer's balance loss)
        when it has one."""
        from torch.autograd.graph import get_gradient_edge
        self.out_edge = get_gradient_edge(y)
        if aux is not None:
            self.aux_edge = get_gradient_edge(aux)
        self.in_edges = tuple(get_gradient_edge(t) for t in leaves)
        self._leaves = leaves

    def distinct(self) -> List[torch.Tensor]:
        """The saved tensors without repeats: two entries that view the
        same storage at the same offset, shape, stride and type are one
        (autograd saves a layer input once for each product it feeds)."""
        keys: Dict[tuple, int] = {}
        out, index = [], []
        for t in self.saved:
            key = (t.untyped_storage().data_ptr(), t.storage_offset(),
                   tuple(t.shape), t.stride(), t.dtype, t.device)
            if key not in keys:
                keys[key] = len(out)
                out.append(t)
            index.append(keys[key])
        self._index = index
        return out

    def nbytes(self) -> int:
        """Bytes of one payload: the distinct saved tensors' elements."""
        return sum(t.numel() * t.element_size() for t in self.distinct())

    def release(self):
        """Drop every device tensor: the saved entries (after ``put`` has
        copied them out) and the leaves' storage."""
        for i in range(len(self.saved)):
            self.saved[i] = None
        for t in self._leaves:
            t.data = torch.empty(0, dtype=t.dtype, device=t.device)
        self._leaves = ()

    def restore(self, tensors: List[torch.Tensor]):
        """Put the tensors :meth:`distinct` listed back in every slot."""
        for i, j in enumerate(self._index):
            self.saved[i] = tensors[j]


class ActivationCoordinator:
    """Activation (autograd-residual) spill/fetch stream, keyed (layer,
    micro-batch).

    Layout per key: the payload — the distinct saved tensors of a
    :class:`LayerResiduals`, each as its raw bytes, concatenated — has its
    ``x_act`` head in the host store (``act:l:m:h``); the tail is written
    to SSD asynchronously (``act:l:m:s``, category ``"act"`` =>
    ``IOPriority.ACT``) and NOT cached — ``get`` re-reads it. The graph
    and each tensor's dtype, shape and stride stay in coordinator memory
    (structure, not data; the same every iteration). ``nbytes``, when
    set, is the payload size every ``put`` must have (the engine sizes it
    once, before the plan is compiled)."""

    def __init__(self, x_act: float, host: HostStore, ssd: SSDStore,
                 meter: TrafficMeter, engine: IOEngine, device="cpu"):
        self.x = x_act
        self.host = host
        self.ssd = ssd
        self.meter = meter
        self.engine = engine
        self.device = torch.device(device)
        self.nbytes: Optional[int] = None
        self._res: Dict[Tuple[int, int], LayerResiduals] = {}
        self._meta: Dict[Tuple[int, int], list] = {}
        self._k: Dict[Tuple[int, int], int] = {}
        self._n: Dict[Tuple[int, int], int] = {}
        self._pending: Dict[Tuple[int, int], IORequest] = {}     # spills
        self._prefetched: Dict[Tuple[int, int], IORequest] = {}  # reads
        self.la_hits = 0        # get() found a landed tail prefetch
        self.la_misses = 0      # get() read the tail synchronously
        self.tracer = None      # engine-attached repro_torch.obs.Tracer
        self._hint_t: Dict[Tuple[int, int], float] = {}

    def _name(self, l: int, m: int) -> str:
        return f"act:{l}:{m}"

    def put(self, l: int, m: int, res: LayerResiduals):
        """Stream micro-batch m's layer-l residuals out (async tail); the
        residuals' device tensors are released."""
        tensors = res.distinct()
        metas = [(t.dtype, tuple(t.shape), t.stride()) for t in tensors]
        n = sum(t.numel() * t.element_size() for t in tensors)
        if self.nbytes is not None and n != self.nbytes:
            raise RuntimeError(f"act payload of layer {l} micro-batch {m} "
                               f"is {n} bytes, the plan's {self.nbytes}")
        t0 = _copy_stamp(self.tracer, self.device, l, m)
        buf = np.empty(n, np.uint8)
        off = 0
        for t in tensors:
            nb = t.numel() * t.element_size()
            if nb:
                torch.from_numpy(buf[off:off + nb]).copy_(
                    t.detach().contiguous().reshape(-1).view(torch.uint8))
            off += nb
        del tensors
        res.release()
        _xfer(self.meter, self.engine, "act", "gpu->cpu", n, self.tracer, t0,
              l, m)
        key = (l, m)
        k = int(round(self.x * n))
        self._res[key] = res
        self._meta[key] = metas
        self._k[key] = k
        self._n[key] = n
        if k:
            self.host.put(self._name(l, m) + ":h", buf[:k].copy())
        if k < n:
            old = self._pending.pop(key, None)
            if old is not None:
                old.result()    # never two in-flight spills of one name
            self._pending[key] = self.ssd.write_async(
                self._name(l, m) + ":s", buf[k:], "act")

    def prefetch(self, l: int, m: int):
        """``PREFETCH_ACT`` hint: start the tail's SSD read now (ACT
        priority). No-op if nothing is spilled, or the spill itself is
        still in flight (a request body must never wait on another
        request)."""
        key = (l, m)
        if key in self._prefetched or key not in self._n:
            return
        k, n = self._k[key], self._n[key]
        if k >= n:
            return
        wr = self._pending.get(key)
        if wr is not None and not wr.done():
            return
        name = self._name(l, m) + ":s"
        self._prefetched[key] = self.engine.submit(
            lambda: self.ssd.read(name, "act"),
            priority=IOPriority.ACT, category="act", route="ssd->cpu",
            nbytes=n - k)
        _hint_issue(self, key)

    def get(self, l: int, m: int) -> LayerResiduals:
        """The residuals back on the device: host head + SSD tail, each
        tensor rebuilt with its dtype, shape and stride. A failed spill
        surfaces HERE — the executor's fallback point for degrading to
        recompute."""
        key = (l, m)
        name = self._name(l, m)
        req = self._prefetched.pop(key, None)
        wr = self._pending.pop(key, None)
        try:
            if wr is not None:
                wr.result()
        except BaseException:
            if req is not None and not req.cancel():
                try:
                    req.result()
                except Exception:
                    pass        # the spill's error is what propagates
            raise
        k, n = self._k[key], self._n[key]
        if req is not None:
            hit = req.done()         # evaluate once: it can flip mid-read
            self.la_hits += hit
            self.la_misses += not hit
            _hint_settle(self, "act", key, "hit" if hit else "late")
            tail = req.result()
        elif k < n:
            self.la_misses += 1
            tail = self.ssd.read(name + ":s", "act")
        else:
            tail = None
        head = self.host.pop(name + ":h") if k else np.zeros(0, np.uint8)
        if tail is None:
            buf = head
        elif head.size:
            buf = np.concatenate([head, tail])
        else:
            buf = tail
        t0 = _copy_stamp(self.tracer, self.device, l, m)
        tensors, off = [], 0
        for dt, shp, st in self._meta[key]:
            t = torch.empty(shp, dtype=dt, device=self.device)
            nb = t.numel() * t.element_size()
            if nb:
                t.reshape(-1).view(torch.uint8).copy_(
                    torch.from_numpy(buf[off:off + nb]))
            if t.stride() != st and _dense_strides(shp, st):
                t = torch.empty_strided(shp, st, dtype=dt,
                                        device=self.device).copy_(t)
            tensors.append(t)
            off += nb
        _xfer(self.meter, self.engine, "act", "cpu->gpu", buf.nbytes,
              self.tracer, t0, l, m)
        res = self._res[key]
        res.restore(tensors)
        self._forget(key)
        return res

    def _forget(self, key):
        for d in (self._res, self._meta, self._k, self._n):
            d.pop(key, None)

    def drop(self, l: int, m: int):
        """Abandon one key: cancel/drain its in-flight requests
        (swallowing their errors — the caller is falling back) and free
        the host head."""
        key = (l, m)
        _hint_settle(self, "act", key, "cancelled")
        for d in (self._prefetched, self._pending):
            req = d.pop(key, None)
            if req is not None:
                _cancel_or_drain(req)
        name = self._name(l, m)
        if name + ":h" in self.host:
            self.host.pop(name + ":h")
        self._forget(key)

    def clear(self):
        """Abandon everything (mid-plan fault cleanup)."""
        keys = set(self._n) | set(self._pending) | set(self._prefetched)
        for l, m in keys:
            self.drop(l, m)

    def wait_pending(self):
        """Drain outstanding spills/reads (finish/teardown)."""
        for d in (self._pending, self._prefetched):
            for req in list(d.values()):
                try:
                    req.result()
                except (CancelledError, OSError):
                    pass
            d.clear()


class KVBlockCoordinator:
    """Tiered KV-cache block stream, keyed (request, layer-unit).

    Layout per key: the flattened cache payload is padded up to
    ``n_blocks * block_bytes`` (``kv_blocks`` — the SAME ceil the plan
    interpreter and ``traffic.kv_traffic`` price), the
    ``round(x_host * n_blocks)`` head blocks live in the host store
    (``kv:r:l:h``), and the cold tail blocks are written to SSD
    asynchronously (``kv:r:l:s``, category ``"kv"`` =>
    ``IOPriority.KV``). Cache treedef and leaf dtypes/shapes stay in
    coordinator memory — structure, not data. ``get`` rebuilds the
    tree bitwise on ``device`` from the true (un-padded) payload
    length."""

    def __init__(self, block_bytes: int, x_host: float, host: HostStore,
                 ssd: SSDStore, meter: TrafficMeter, engine: IOEngine,
                 device="cpu"):
        if block_bytes <= 0:
            raise ValueError(f"block_bytes must be > 0, got {block_bytes}")
        self.block_bytes = int(block_bytes)
        self.x = float(x_host)
        self.host = host
        self.ssd = ssd
        self.meter = meter
        self.engine = engine
        self.device = torch.device(device)
        self._tree: Dict[Tuple[int, int], object] = {}
        self._meta: Dict[Tuple[int, int], list] = {}
        self._k: Dict[Tuple[int, int], int] = {}       # host head blocks
        self._blocks: Dict[Tuple[int, int], int] = {}  # total blocks
        self._n: Dict[Tuple[int, int], int] = {}       # true payload bytes
        self._pending: Dict[Tuple[int, int], IORequest] = {}     # spills
        self._prefetched: Dict[Tuple[int, int], IORequest] = {}  # reads
        self.la_hits = 0        # get() found a landed tail prefetch
        self.la_misses = 0      # get() read the cold tail synchronously
        self.tracer = None      # engine-attached repro_torch.obs.Tracer
        self._hint_t: Dict[Tuple[int, int], float] = {}

    def _name(self, r: int, l: int) -> str:
        return f"kv:{r}:{l}"

    def blocks_of(self, nbytes: int) -> int:
        from repro_torch.core.traffic import kv_blocks
        return kv_blocks(nbytes, self.block_bytes)

    def put(self, r: int, l: int, caches):
        """SPILL_KV: evict request r's layer-unit-l cache tree to the
        tiers (all blocks off device; cold tail to SSD, async)."""
        buf, treedef, metas = tree_to_bytes(caches)
        bb = self.block_bytes
        nbk = self.blocks_of(buf.size)
        pad = np.zeros(nbk * bb, np.uint8)
        pad[:buf.size] = buf
        _xfer(self.meter, self.engine, "kv", "gpu->cpu", pad.nbytes)
        key = (r, l)
        kb = int(round(self.x * nbk))
        self._tree[key] = treedef
        self._meta[key] = metas
        self._k[key] = kb
        self._blocks[key] = nbk
        self._n[key] = buf.size
        if kb:
            self.host.put(self._name(r, l) + ":h", pad[:kb * bb].copy())
        if kb < nbk:
            old = self._pending.pop(key, None)
            if old is not None:
                old.result()    # never two in-flight spills of one name
            self._pending[key] = self.ssd.write_async(
                self._name(r, l) + ":s", pad[kb * bb:], "kv")

    def prefetch(self, r: int, l: int):
        """``PREFETCH_KV`` hint: start the cold tail's SSD read now (KV
        priority). No-op if nothing is spilled or the spill itself is
        still in flight (a request body must never wait on another
        request)."""
        key = (r, l)
        if key in self._prefetched or key not in self._blocks:
            return
        kb, nbk = self._k[key], self._blocks[key]
        if kb >= nbk:
            return
        wr = self._pending.get(key)
        if wr is not None and not wr.done():
            return
        name = self._name(r, l) + ":s"
        self._prefetched[key] = self.engine.submit(
            lambda: self.ssd.read(name, "kv"),
            priority=IOPriority.KV, category="kv", route="ssd->cpu",
            nbytes=(nbk - kb) * self.block_bytes)
        _hint_issue(self, key)

    def get(self, r: int, l: int):
        """FETCH_KV: restore the cache tree bitwise — host head
        blocks + SSD cold tail, truncated back to the true payload."""
        key = (r, l)
        name = self._name(r, l)
        req = self._prefetched.pop(key, None)
        wr = self._pending.pop(key, None)
        try:
            if wr is not None:
                wr.result()
        except BaseException:
            if req is not None and not req.cancel():
                try:
                    req.result()
                except Exception:
                    pass        # the spill's error is what propagates
            raise
        kb, nbk = self._k[key], self._blocks[key]
        if req is not None:
            hit = req.done()         # evaluate once: it can flip mid-read
            self.la_hits += hit
            self.la_misses += not hit
            _hint_settle(self, "kv", key, "hit" if hit else "late")
            tail = req.result()
        elif kb < nbk:
            self.la_misses += 1
            tail = self.ssd.read(name + ":s", "kv")
        else:
            tail = None
        head = (self.host.pop(name + ":h") if kb
                else np.zeros(0, np.uint8))
        if tail is None:
            pad = head
        elif head.size:
            pad = np.concatenate([head, tail])
        else:
            pad = tail
        _xfer(self.meter, self.engine, "kv", "cpu->gpu", pad.nbytes)
        dev = torch.from_numpy(pad[:self._n[key]]).to(self.device)
        caches = tree_from_bytes(dev, self._tree[key], self._meta[key])
        self._forget(key)
        return caches

    def _forget(self, key):
        for d in (self._tree, self._meta, self._k, self._blocks, self._n):
            d.pop(key, None)

    def drop(self, r: int, l: int):
        """Abandon one key (finished request whose blocks are freed
        without a resume): cancel/drain in-flight requests, free the
        host head, delete the SSD tail."""
        key = (r, l)
        _hint_settle(self, "kv", key, "cancelled")
        pre = self._prefetched.pop(key, None)
        if pre is not None:
            _cancel_or_drain(pre)
        wr = self._pending.pop(key, None)
        if wr is not None:
            try:
                wr.result()   # let the write land, then delete the name
            except Exception:
                pass
        name = self._name(r, l)
        if name + ":h" in self.host:
            self.host.pop(name + ":h")
        kb = self._k.get(key)
        nbk = self._blocks.get(key)
        if kb is not None and nbk is not None and kb < nbk:
            try:
                self.ssd.delete(name + ":s")
            except KeyError:
                pass
        self._forget(key)

    def clear(self):
        """Abandon everything (engine teardown / fault cleanup)."""
        keys = set(self._n) | set(self._pending) | set(self._prefetched)
        for r, l in keys:
            self.drop(r, l)

    def wait_pending(self):
        """Drain outstanding spills/reads (finish/teardown)."""
        for d in (self._pending, self._prefetched):
            for req in list(d.values()):
                try:
                    req.result()
                except (CancelledError, OSError):
                    pass
            d.clear()

