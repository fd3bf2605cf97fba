"""Configuration for the async I/O engine (`repro_torch.io.IOEngine`).

Routes are named ``"src->dst"`` over the three tiers (``gpu``, ``cpu``,
``ssd``) — the same strings the :class:`~repro_torch.offload.stores.TrafficMeter`
uses, so one config describes both the real transfer topology and the
optional simulated bandwidth caps.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Mapping, Optional, Sequence

#: The chunk->path placement policies (``IOConfig.path_policy``).
#: "static" is the layout constant (chunk i -> path i % P, bit-for-bit
#: the pre-placement-scheduling behavior); "weighted" spreads chunk
#: bytes proportionally to the per-path bandwidth caps; "backlog" is
#: MLP-Offload's idle-level rule — each chunk goes to the path whose
#: queued bytes drain soonest under its rate.
PATH_POLICIES = ("static", "weighted", "backlog")


@dataclasses.dataclass(frozen=True)
class IOConfig:
    """Knobs of the transfer engine.

    * ``paths`` — SSD mount points (directories). More than one enables
      MLP-Offload-style striping across per-path channel threads, so
      transfers proceed in parallel across paths. WHERE a chunk lands
      is the ``path_policy`` decision (default: chunk *i* on path
      ``i % len(paths)``).
    * ``chunk_bytes`` — stripe unit; also the staging-buffer size.
    * ``inflight_bytes`` — backpressure budget: ``IOEngine.submit``
      blocks while the bytes of queued+running requests would exceed it
      (a single oversized request is admitted when the engine is idle).
    * ``workers`` — request-level worker threads (chunk execution runs
      on the per-path channel threads, not these). Keep >= 2: a
      parameter-fetch request may *gate* on a lower-priority optimizer
      request (the α-delay ordering), so at least one worker must stay
      free to run the gating request.
    * ``bandwidth`` — optional simulated caps, route -> bytes/s
      (e.g. ``{"cpu->ssd": 2e9, "ssd->cpu": 4e9, "cpu->gpu": 24e9}``).
      Empty dict = no pacing. Used to validate
      :mod:`repro_torch.core.perfmodel` rooflines in wall-clock.
    * ``staging_buffers`` — host staging pool depth for asynchronous
      spills (2 = classic double buffering).
    * ``path_policy`` — chunk->path placement (:data:`PATH_POLICIES`):
      ``"static"`` reproduces the round-robin layout constant
      bit-for-bit; ``"weighted"`` splits chunk bytes proportionally to
      the per-path caps; ``"backlog"`` places each chunk on the path
      whose queued bytes drain soonest (live feedback). Placement
      moves bytes BETWEEN paths only — per-(category, route) traffic
      is policy-invariant.
    * ``path_bandwidth`` — optional per-path simulated caps, bytes/s,
      index = path (e.g. ``(0.2e9, 0.05e9)`` models a 4:1 fast/slow
      pair). Each path gets its own token bucket, shared by its reads
      and writes — a per-DEVICE cap, where ``bandwidth`` caps a
      ROUTE across all paths. Also the rate weights of the
      "weighted"/"backlog" policies. Must match ``len(paths)`` when
      both are given.
    * ``retries`` — bounded retry budget per chunk op for TRANSIENT
      faults (EAGAIN/EINTR/ETIMEDOUT-class errors and first-round
      checksum mismatches): each attempt backs off exponentially from
      ``retry_backoff_s``, capped by the op's priority-class timeout
      (:data:`repro_torch.io.engine.RETRY_TIMEOUT_S` — a critical-path param
      fetch gives up sooner than a deferrable spill). Permanent faults
      (EIO, short reads, dead devices) never retry — they propagate
      immediately so the per-path failure drain and the write-failover
      path can act. ``retries=0`` disables the loop entirely.
    * ``retry_backoff_s`` — initial backoff before the first retry;
      doubles per attempt.
    * ``integrity`` — record a CRC32C per complete chunk in the
      chunk-location sidecar at write time and verify it on every
      complete-chunk read (:mod:`repro_torch.io.integrity`): silent
      corruption and torn writes raise ``IntegrityError`` instead of
      feeding garbage to training. Off by default (pure-Python CRC
      costs ~0.1 s/MB, and integrity-off runs must keep producing zero
      sidecars under the static layout pin).
    """

    paths: Optional[Sequence[str]] = None
    chunk_bytes: int = 1 << 20
    inflight_bytes: int = 1 << 30
    workers: int = 4
    bandwidth: Mapping[str, float] = dataclasses.field(default_factory=dict)
    staging_buffers: int = 2
    path_policy: str = "static"
    path_bandwidth: Optional[Sequence[float]] = None
    retries: int = 2
    retry_backoff_s: float = 0.002
    integrity: bool = False

    def __post_init__(self):
        if self.path_policy not in PATH_POLICIES:
            raise ValueError(
                f"path_policy {self.path_policy!r} not in {PATH_POLICIES}")
        if int(self.retries) < 0:
            raise ValueError(f"retries={self.retries} must be >= 0")
        if float(self.retry_backoff_s) < 0:
            raise ValueError(
                f"retry_backoff_s={self.retry_backoff_s} must be >= 0")
        if self.path_bandwidth is not None:
            caps = tuple(float(c) for c in self.path_bandwidth)
            if any(c <= 0 for c in caps):
                raise ValueError(
                    f"path_bandwidth caps must be > 0, got {caps}")
            if self.paths is not None and len(caps) != len(self.paths):
                raise ValueError(
                    f"path_bandwidth has {len(caps)} cap(s) for "
                    f"{len(self.paths)} path(s)")
            object.__setattr__(self, "path_bandwidth", caps)

    def resolved_paths(self, default_root: str) -> Sequence[str]:
        """The stripe directories, falling back to a single default."""
        return list(self.paths) if self.paths else [default_root]

    def shard_for_rank(self, rank: int, world: int) -> "IOConfig":
        """Per-rank view of a data-parallel path set (N ranks x N SSD
        paths): rank ``r`` drives paths ``r, r+world, ...`` with its own
        engine, so the ranks' channel threads saturate disjoint devices.
        With fewer paths than ranks, ranks share a device through
        per-rank subdirectories (disjoint stripe namespaces — correct,
        but those ranks contend for the device's bandwidth). With no
        paths configured the caller's per-rank ``default_root``
        applies. ``path_bandwidth`` caps follow their paths through
        the slice, so a rank's placement policy weighs exactly the
        devices it drives."""
        if not (0 <= rank < world):
            raise ValueError(f"rank {rank} outside world of {world}")
        if not self.paths:
            return self
        caps = self.path_bandwidth
        mine = list(self.paths)[rank::world]
        mine_caps = None if caps is None else tuple(caps[rank::world])
        if not mine:
            base_i = rank % len(self.paths)
            mine = [os.path.join(list(self.paths)[base_i], f"rank{rank}")]
            # the shared device's cap applies to the subdirectory too
            mine_caps = None if caps is None else (caps[base_i],)
        return dataclasses.replace(self, paths=mine,
                                   path_bandwidth=mine_caps)
