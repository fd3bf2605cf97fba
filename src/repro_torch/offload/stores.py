"""Three-tier tensor storage: device (torch) / host (numpy) / SSD (files).

The device tier is the engine's torch device (a CUDA card, or the CPU
in the tests); the host tier is numpy buffers (on a card, the
checkpoint tier's are views of a :class:`PinnedPool`'s page-locked
slots) and the SSD tier the filesystem. numpy has no bf16, so a bf16
tensor lives on the host as its ``uint16`` bit patterns
(:func:`host_dtype`, :func:`to_host`, :func:`to_device`): element
counts, and so every tier split ``k = round(x·n)`` and every byte
meter, are the same as for a real 2-byte type. All traffic is metered
by category so the engine's counters can be validated against the
closed-form model in repro_torch.core.traffic.

All SSD bytes move through :class:`repro_torch.io.IOEngine`: chunked,
priority-scheduled, striped across the engine's configured paths, and
optionally bandwidth-paced. ``SSDStore`` is the tensor-naming layer on
top (shapes/dtypes, metering, async spills via the staging pool).
"""
from __future__ import annotations

import threading
from collections import defaultdict, deque
from concurrent.futures import CancelledError
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.io import (CATEGORY_PRIORITY, IOConfig, IOEngine, IOPriority,
                      IORequest, StripedFiles)
from repro_torch.offload.buffers import pack


def host_dtype(dtype: torch.dtype) -> np.dtype:
    """The numpy type that holds ``dtype``'s elements on the host."""
    if dtype == torch.bfloat16:
        return np.dtype(np.uint16)
    return np.dtype(torch.empty((), dtype=dtype).numpy().dtype)


def to_host(t: torch.Tensor) -> np.ndarray:
    """A tensor's elements as a host numpy array with the same bits (bf16
    as ``uint16`` bit patterns). Runs on the caller's thread: it is the
    device -> host copy."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).cpu().numpy().view(np.uint16)
    return t.cpu().numpy()


def to_device(arr: np.ndarray, dtype: torch.dtype, shape,
              device) -> torch.Tensor:
    """Inverse of :func:`to_host`: the host array's bits as a ``dtype``
    tensor of ``shape`` on ``device``."""
    if dtype == torch.bfloat16:
        t = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16))
        return t.to(device).view(torch.bfloat16).reshape(shape)
    return torch.from_numpy(arr).to(device).reshape(shape)


def host_cast(arr: np.ndarray, dtype: torch.dtype) -> np.ndarray:
    """f32 host values converted to ``dtype``'s host form: bf16 rounds to
    nearest even (through ``torch``'s conversion) and returns ``uint16``
    bit patterns; other types are a numpy ``astype`` copy."""
    if dtype == torch.bfloat16:
        return torch.from_numpy(arr).to(torch.bfloat16).view(
            torch.int16).numpy().view(np.uint16)
    return arr.astype(host_dtype(dtype))


class TrafficMeter:
    """Byte counters keyed by (category, route)."""

    def __init__(self):
        self._lock = threading.Lock()
        self.bytes: Dict[Tuple[str, str], int] = defaultdict(int)

    def add(self, category: str, route: str, n: int):
        with self._lock:
            self.bytes[(category, route)] += int(n)

    def total(self, route_prefix: str = "") -> int:
        return sum(v for (c, r), v in self.bytes.items()
                   if r.startswith(route_prefix))

    def by_category(self) -> Dict[str, int]:
        out: Dict[str, int] = defaultdict(int)
        for (c, r), v in self.bytes.items():
            out[c] += v
        return dict(out)

    def snapshot(self) -> Dict[str, int]:
        with self._lock:
            return {f"{c}:{r}": v for (c, r), v in sorted(self.bytes.items())}

    def reset(self):
        with self._lock:
            self.bytes.clear()


def _u8(arr: np.ndarray) -> np.ndarray:
    """Flat uint8 view of a contiguous array (no copy)."""
    return arr.reshape(-1).view(np.uint8)


def _priority(category: str) -> IOPriority:
    return CATEGORY_PRIORITY.get(category, IOPriority.CKPT_SPILL)


class SSDStore:
    """Named flat tensors on SSD, striped across the I/O engine's paths.

    Overwrites must keep a tensor's byte size (partial updates go through
    ``write_range``); the offload engine's tensors are all fixed-size.
    """

    def __init__(self, root: str, meter: TrafficMeter,
                 engine: Optional[IOEngine] = None,
                 chunk_bytes: Optional[int] = None):
        self.root = root
        self.meter = meter
        if engine is None:
            cfg = IOConfig(paths=[root]) if chunk_bytes is None else \
                IOConfig(paths=[root], chunk_bytes=chunk_bytes)
            engine = IOEngine(cfg, meter=meter)
            self._owns_engine = True
        else:
            self._owns_engine = False
        self.engine = engine
        self.files = StripedFiles(engine)
        self._shapes: Dict[str, Tuple[tuple, np.dtype]] = {}
        self._async_reqs: set = set()
        self._async_lock = threading.Lock()

    def _meta(self, name: str) -> Tuple[tuple, np.dtype]:
        try:
            return self._shapes[name]
        except KeyError:
            raise KeyError(
                f"SSDStore: no tensor named {name!r} is registered "
                f"({len(self._shapes)} known names)") from None

    def write(self, name: str, arr: np.ndarray, category: str,
              metered: bool = True):
        arr = np.ascontiguousarray(arr)
        self.files.write(name, _u8(arr), 0, _priority(category))
        self._shapes[name] = (arr.shape, arr.dtype)
        if metered:
            self.meter.add(category, "cpu->ssd", arr.nbytes)

    def write_async(self, name: str, arr: np.ndarray, category: str
                    ) -> IORequest:
        """Stage ``arr`` into the double-buffered host pool and schedule
        the (chunked, striped) write; the caller's buffer is free as soon
        as this returns. Wait on the returned request before reading."""
        arr = np.ascontiguousarray(arr)
        staged = self.engine.staging.acquire(arr.nbytes)
        np.copyto(staged.view, _u8(arr))
        self._shapes[name] = (arr.shape, arr.dtype)
        pri = _priority(category)
        nbytes = arr.nbytes

        def work():
            try:
                self.files.write(name, staged.view, 0, pri)
                self.meter.add(category, "cpu->ssd", nbytes)
            finally:
                staged.release()

        req = self.engine.submit(work, priority=pri, category=category,
                                 route="cpu->ssd", nbytes=nbytes)
        with self._async_lock:
            self._async_reqs.add(req)

        def _done(f):
            # a cancelled spill never runs `work`; don't leak the slot
            if f.cancelled():
                staged.release()
            with self._async_lock:
                self._async_reqs.discard(req)

        req.future.add_done_callback(_done)
        return req

    def read(self, name: str, category: str, out: Optional[np.ndarray] = None
             ) -> np.ndarray:
        shape, dtype = self._meta(name)
        nbytes = int(np.prod(shape)) * dtype.itemsize
        pri = _priority(category)
        if out is not None and out.flags.c_contiguous and out.nbytes == nbytes:
            self.files.readinto(name, _u8(out), 0, pri)
            self.meter.add(category, "ssd->cpu", nbytes)
            return out
        arr = np.empty(shape, dtype)
        self.files.readinto(name, _u8(arr), 0, pri)
        self.meter.add(category, "ssd->cpu", nbytes)
        if out is not None:
            np.copyto(out, arr)
            return out
        return arr

    def read_range(self, name: str, lo: int, hi: int, category: str,
                   out: Optional[np.ndarray] = None) -> np.ndarray:
        """Partial read of elements [lo, hi) — only the needed fraction
        touches the SSD paths (the paper's chunked optimizer I/O; the
        data-parallel engine's rank-shard fetches). With a contiguous
        ``out`` of the right size the chunk ops land directly in the
        caller's buffer (no intermediate allocation)."""
        _, dtype = self._meta(name)
        n = hi - lo
        if out is not None and out.flags.c_contiguous \
                and out.size == n and out.dtype == dtype:
            arr = out
        else:
            arr = np.empty(n, dtype)
        self.files.readinto(name, _u8(arr), lo * dtype.itemsize,
                            _priority(category))
        self.meter.add(category, "ssd->cpu", arr.nbytes)
        if out is not None and arr is not out:
            np.copyto(out, arr)
            return out
        return arr

    def write_range(self, name: str, arr: np.ndarray, lo: int,
                    category: str):
        """Partial in-place write of elements [lo, lo+len)."""
        _, dtype = self._meta(name)
        arr = np.ascontiguousarray(arr, dtype=dtype)
        self.files.write(name, _u8(arr), lo * dtype.itemsize,
                         _priority(category))
        self.meter.add(category, "cpu->ssd", arr.nbytes)

    def delete(self, name: str):
        """Remove a tensor's stripe files and registration."""
        self._meta(name)
        self.files.delete(name)
        del self._shapes[name]

    def clear(self):
        """Delete every registered tensor's files (workdir cleanup)."""
        for name in list(self._shapes):
            self.delete(name)

    def exists(self, name: str) -> bool:
        return name in self._shapes

    def nbytes(self) -> int:
        return sum(int(np.prod(s)) * d.itemsize
                   for s, d in self._shapes.values())

    def close(self):
        # Drain async spills first: a spill still queued when clear()
        # unlinks the stripe files would recreate them via O_CREAT.
        with self._async_lock:
            pending = list(self._async_reqs)
        for req in pending:
            try:
                req.result()
            except CancelledError:
                pass
        self.clear()
        self.files.close()
        if self._owns_engine:
            self.engine.shutdown(wait=True)


class HostStore:
    """Named host numpy buffers: pageable arrays, or views of a
    :class:`PinnedPool` slot for the checkpoints and inter-layer
    gradients of an engine on a card. Tracks resident bytes — the CPU-memory
    budget the LP of Algorithm 1 constrains — and the peak residency
    (``peak_nbytes``), updated on every put, for validating the vertical
    schedule's footprint against the LP solution."""

    def __init__(self, meter: TrafficMeter):
        self.meter = meter
        self._bufs: Dict[str, np.ndarray] = {}
        self._lock = threading.Lock()
        self._nbytes = 0
        self.peak_nbytes = 0

    def put(self, name: str, arr: np.ndarray):
        with self._lock:
            old = self._bufs.get(name)
            if old is not None:
                self._nbytes -= old.nbytes
            self._bufs[name] = arr
            self._nbytes += arr.nbytes
            if self._nbytes > self.peak_nbytes:
                self.peak_nbytes = self._nbytes

    def get(self, name: str) -> np.ndarray:
        return self._bufs[name]

    def pop(self, name: str) -> np.ndarray:
        with self._lock:
            arr = self._bufs.pop(name)
            self._nbytes -= arr.nbytes
        return arr

    def __contains__(self, name: str) -> bool:
        return name in self._bufs

    def nbytes(self) -> int:
        return self._nbytes


class PoolSlot:
    """One slot of a :class:`PinnedPool`: ``t``, a ``uint8`` view of
    ``size`` bytes inside one block; ``d2h`` / ``h2d``, the card events of
    the last copy into and out of it (None until one ran, and on the
    CPU)."""

    __slots__ = ("t", "d2h", "h2d")

    def __init__(self, t: torch.Tensor):
        self.t, self.d2h, self.h2d = t, None, None


def _max_slots(n: int, size: int, budget: int) -> int:
    """The most slots, at most ``n``, whose ``pack`` fits ``budget``
    bytes (``pack``'s total grows with the count)."""
    lo, hi = 0, n
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if pack(mid, size)[0] <= budget:
            lo = mid
        else:
            hi = mid - 1
    return lo


class PinnedPool:
    """Reused page-locked host slots for fixed-size payloads (GreedySnake
    §5): slots of ``size`` bytes for ``n`` payloads, carved out of the
    power-of-two blocks that :func:`repro_torch.offload.buffers.pack`
    chooses, so no slot spans two blocks and the pinned allocator's
    power-of-two padding wastes nothing beyond ``pack``'s. Allocated
    once and reused; ``budget`` caps the pinned bytes (the pool then
    holds the most slots whose ``pack`` fits it). ``pin=False`` makes the
    same slots in pageable memory (tests on a host without a card).

    A slot is taken with :meth:`acquire` (None when every slot is held)
    and given back with :meth:`release`; the oldest released slot is
    taken first, so the copy out of it has had the longest to finish."""

    def __init__(self, n: int, size: int, pin: bool = True,
                 budget: Optional[int] = None):
        if size <= 0:
            raise ValueError(f"slot size {size} must be positive")
        self.asked = n
        if budget is not None:
            n = _max_slots(n, size, budget)
        self.n = n
        self.size = size
        self.pinned = pin
        total, blocks = pack(n, size) if n else (0, [])
        self.nbytes = total
        self.blocks = [torch.empty(b, dtype=torch.uint8, pin_memory=pin)
                       for b in blocks]
        self._free = deque(
            PoolSlot(blk[i * size:(i + 1) * size])
            for blk in self.blocks for i in range(blk.numel() // size))
        self.nslots = len(self._free)

    def acquire(self) -> Optional[PoolSlot]:
        return self._free.popleft() if self._free else None

    def release(self, slot: PoolSlot):
        self._free.append(slot)

    def free(self) -> int:
        """Slots not held."""
        return len(self._free)


class TieredVector:
    """A flat 1-D tensor split between host memory and SSD by a ratio
    x in [0,1] (fraction host-resident): elements [0, k) live in host,
    [k, n) on SSD — the paper's per-data-type storage ratio. SSD bytes
    move as chunked engine requests at the priority of ``category``."""

    def __init__(self, name: str, n: int, dtype, x_host: float,
                 host: HostStore, ssd: SSDStore, category: str):
        self.name = name
        self.n = n
        self.dtype = np.dtype(dtype)
        self.k = int(round(x_host * n))
        self.host = host
        self.ssd = ssd
        self.category = category

    def write_full(self, arr: np.ndarray):
        """Initial population (not counted as training traffic)."""
        assert arr.shape == (self.n,) and arr.dtype == self.dtype
        if self.k:
            self.host.put(self.name + ":h", arr[:self.k].copy())
        if self.k < self.n:
            self.ssd.write(self.name + ":s", arr[self.k:], self.category,
                           metered=False)

    def read(self, out: Optional[np.ndarray] = None) -> np.ndarray:
        """Assemble the full vector; SSD portion is metered."""
        if out is None:
            out = np.empty((self.n,), self.dtype)
        if self.k:
            np.copyto(out[:self.k], self.host.get(self.name + ":h"))
        if self.k < self.n:
            self.ssd.read(self.name + ":s", self.category, out=out[self.k:])
        return out

    def write(self, arr: np.ndarray, lo: int = 0, hi: Optional[int] = None):
        """Write back elements [lo, hi); SSD portion is metered."""
        hi = self.n if hi is None else hi
        if lo < self.k:
            h = min(hi, self.k)
            np.copyto(self.host.get(self.name + ":h")[lo:h], arr[lo:h])
        if hi > self.k:
            lo_s = max(lo, self.k)
            if lo_s == self.k and hi == self.n:
                self.ssd.write(self.name + ":s", arr[self.k:], self.category)
            else:
                # partial SSD write: only [lo_s, hi) touches disk
                self.ssd.write_range(self.name + ":s",
                                     arr[lo_s:hi], lo_s - self.k,
                                     self.category)

    def write_seg(self, data: np.ndarray, lo: int):
        """Write back the segment [lo, lo+len(data)) given only the
        segment's data (no full-size staging buffer needed)."""
        hi = lo + data.size
        if lo < self.k:
            h = min(hi, self.k)
            np.copyto(self.host.get(self.name + ":h")[lo:h], data[:h - lo])
        if hi > self.k:
            lo_s = max(lo, self.k)
            self.ssd.write_range(self.name + ":s", data[lo_s - lo:],
                                 lo_s - self.k, self.category)

    def read_range(self, lo: int, hi: int, out: Optional[np.ndarray] = None
                   ) -> np.ndarray:
        if out is None:
            out = np.empty((hi - lo,), self.dtype)
        if lo < self.k:
            h = min(hi, self.k)
            np.copyto(out[:h - lo], self.host.get(self.name + ":h")[lo:h])
        if hi > self.k:
            lo_s = max(lo, self.k)
            self.ssd.read_range(self.name + ":s", lo_s - self.k,
                                hi - self.k, self.category,
                                out=out[lo_s - lo:])
        return out
