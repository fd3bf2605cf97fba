"""Token-bucket bandwidth pacing, per transfer route and per SSD path.

The container's filesystem is far faster than the SSDs the paper models,
so byte counters alone cannot validate the perf model's *time*
predictions. Two independent simulators pace the chunk stream:

* :class:`BandwidthSimulator` — one bucket per ROUTE
  (``IOConfig.bandwidth``): models a shared link (the PCIe/NVMe fabric
  every path rides).
* :class:`PathBandwidthSimulator` — one bucket per PATH
  (``IOConfig.path_bandwidth``, index = path), shared by that path's
  reads and writes: models per-DEVICE speed, including heterogeneous
  path sets (a fast and a slow NVMe behind one stripe). This is the
  regime where chunk->path placement (``IOConfig.path_policy``)
  matters: static striping pins the aggregate at P x min(cap), while
  backlog-aware placement approaches sum(caps).

Both apply per chunk, before the syscall; a chunk pays each configured
cap it crosses. `bench_io` measures the achieved rates against the
caps, turning `repro_torch.core.perfmodel` rooflines into wall-clock
observables.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, List, Mapping, Optional, Sequence


class TokenBucket:
    """Classic token bucket: ``rate`` bytes/s refill, ``burst`` bytes
    capacity. ``consume(n)`` may overdraw the bucket and then sleeps off
    the deficit, so the *aggregate* rate across any number of threads
    converges to ``rate`` while short transfers keep sub-burst latency.
    """

    def __init__(self, rate: float, burst: Optional[float] = None):
        if rate <= 0:
            raise ValueError(f"TokenBucket rate must be > 0, got {rate}")
        self.rate = float(rate)
        self.burst = float(burst) if burst is not None else max(rate / 64.0,
                                                                1 << 16)
        self._tokens = self.burst
        self._t = time.perf_counter()
        self._lock = threading.Lock()

    def consume(self, nbytes: int):
        if nbytes <= 0:
            return
        with self._lock:
            now = time.perf_counter()
            self._tokens = min(self.burst,
                               self._tokens + (now - self._t) * self.rate)
            self._t = now
            self._tokens -= nbytes
            wait = -self._tokens / self.rate if self._tokens < 0 else 0.0
        if wait > 0:
            time.sleep(wait)


class BandwidthSimulator:
    """Per-route token buckets built from an ``IOConfig.bandwidth`` map.
    Unconfigured routes pass through untouched."""

    def __init__(self, caps: Mapping[str, float]):
        self._buckets: Dict[str, TokenBucket] = {
            route: TokenBucket(bw) for route, bw in caps.items() if bw}

    def throttle(self, route: str, nbytes: int):
        b = self._buckets.get(route)
        if b is not None:
            b.consume(nbytes)

    def cap(self, route: str) -> Optional[float]:
        b = self._buckets.get(route)
        return b.rate if b is not None else None

    def __bool__(self) -> bool:
        return bool(self._buckets)


class PathBandwidthSimulator:
    """Per-path token buckets built from an ``IOConfig.path_bandwidth``
    sequence (index = path; ``None`` = no per-path pacing). Each path's
    bucket is shared by its reads and writes — a device cap, not a
    route cap. Doubles as the rate-weight source for the
    "weighted"/"backlog" placement policies (:meth:`weights`)."""

    def __init__(self, caps: Optional[Sequence[float]], n_paths: int):
        caps = list(caps) if caps else []
        if caps and len(caps) != n_paths:
            raise ValueError(
                f"path_bandwidth has {len(caps)} cap(s) for "
                f"{n_paths} path(s)")
        self._caps = [float(c) for c in caps]
        self._buckets: List[Optional[TokenBucket]] = [
            TokenBucket(c) for c in self._caps] if caps else \
            [None] * n_paths

    def throttle(self, path_index: int, nbytes: int):
        b = self._buckets[path_index]
        if b is not None:
            b.consume(nbytes)

    def cap(self, path_index: int) -> Optional[float]:
        return self._caps[path_index] if self._caps else None

    def weights(self) -> List[float]:
        """Relative placement weights, one per path: the configured
        caps, or all-equal when no per-path pacing is set."""
        return list(self._caps) if self._caps \
            else [1.0] * len(self._buckets)

    def __bool__(self) -> bool:
        return bool(self._caps)
