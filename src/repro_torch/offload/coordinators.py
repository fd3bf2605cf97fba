"""The coordinators of the serving path (GreedySnake §5, as the
reference's ``offload.coordinators``):

* ParameterCoordinator — per-unit params in tiered storage; two-stage
  prefetch (§4.2): the async engine request performs the SSD->host stage
  (scheduled by the plan's ``PREFETCH`` hints), the host->device copy
  happens at consumption on the caller's thread, and the device copy is
  dropped after use. ``reset()`` cancels in-flight fetches via the I/O
  engine's cancellation API at a schedule boundary.
* KVBlockCoordinator — the serving-time KV-cache block stream: an
  evicted request's per-unit cache tree is flattened to one byte payload
  through torch byte views, padded to a whole number of fixed-size blocks
  (``kv_blocks``), the ``x_host`` head blocks kept in host memory and the
  cold tail streamed to SSD at ``IOPriority.KV``. Resume restores every
  block bitwise onto the engine's device: the true payload length, the
  tree structure and each leaf's torch dtype and shape are kept in
  coordinator memory, so padding never leaks into the rebuilt tree.

Both count lookahead hits/misses (``la_hits`` / ``la_misses``) and, when
the engine attaches its ``repro_torch.obs.Tracer`` (the ``tracer``
attribute), record one lifecycle span per hinted prefetch. The
activation, inter-layer and optimizer coordinators of the training
path come with the training slice.
"""
from __future__ import annotations

import math
import time
from concurrent.futures import CancelledError
from typing import Dict, List, Tuple

import numpy as np
import torch

from repro_torch import tree
from repro_torch.io import IOEngine, IOPriority, IORequest
from repro_torch.obs.tracer import CAT_HINT
from repro_torch.offload.stores import HostStore, SSDStore, TieredVector, TrafficMeter


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


def _xfer(meter: TrafficMeter, engine: IOEngine, category: str, route: str,
          nbytes: int):
    """Meter + (optionally) pace one device-side copy — the single place
    the meter.add/throttle pair lives for non-chunked transfers."""
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
    def __init__(self, vectors: List[TieredVector], meter: TrafficMeter,
                 engine: IOEngine, device="cpu"):
        self.vectors = vectors
        self.meter = meter
        self.engine = engine
        self.device = torch.device(device)
        self._futures: Dict[int, IORequest] = {}
        self.la_hits = 0        # get() found a completed prefetch
        self.la_misses = 0      # get() had to wait (or submit) the fetch
        self.tracer = None      # engine-attached repro_torch.obs.Tracer
        self._hint_t: Dict[int, float] = {}

    def prefetch(self, l: int, consumer: bool = False):
        """Submit unit l's async SSD -> host fetch (the two-stage §4.2
        pipeline's first stage). The host -> device copy stays in
        :meth:`get` on the consumer thread — doing it on an engine worker
        would steal CPU from the overlapped compute the lookahead exists
        to protect."""
        if not (0 <= l < len(self.vectors)) or l in self._futures:
            return
        v = self.vectors[l]
        self._futures[l] = self.engine.submit(
            v.read, priority=IOPriority.PARAM_FETCH, category="param",
            route="ssd->cpu", nbytes=v.n * v.dtype.itemsize)
        if not consumer:
            _hint_issue(self, l)

    def get(self, l: int) -> torch.Tensor:
        """Unit l's vector on the device: waits for (or submits) the host
        fetch, then copies it host -> device."""
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
        dev = torch.from_numpy(host_arr).to(self.device)   # "PCIe" copy
        _xfer(self.meter, self.engine, "param", "cpu->gpu", host_arr.nbytes)
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

