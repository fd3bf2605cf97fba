"""First-class fault injection for the I/O fabric: ``ChaosFiles``, a
:class:`repro_torch.io.backend.StripedFiles` whose raw chunk ops misbehave on
demand — deterministic countdown fuses for the fault batteries,
scripted path death for failover drills, and a seeded probabilistic
:class:`ChaosSpec` (transient errors, latency spikes, torn writes, bit
flips) for whole-training chaos sweeps and the degraded-mode benchmark
cells.

This promotes the injectors the fault tests grew locally
(``FaultyFiles`` / ``DeadPathFiles`` / ``ActFaultyFiles``) into the
library, with the same semantics the batteries pinned:

* **Countdown fuses** (``fail_writes`` / ``fail_reads``): each faulting
  op decrements its fuse and raises ``OSError(EIO, "injected
  write|read fault")`` until it reaches zero. EIO is deliberately
  PERMANENT under the engine's fault classification — one fused fault
  propagates to ``IORequest.result()`` on the first attempt, which is
  exactly what the leak/cleanup batteries assert.
* **Short reads** (``short_reads``): reads return half the requested
  bytes, exercising the short-read detection in the backend.
* **Name-targeted fuses** (``fail_name_writes`` / ``fail_name_reads``:
  name-prefix -> countdown; ``fail_prefix``: one-shot write fuse): aim
  a fault at one STREAM (``"act:"``, a ckpt boundary tensor) when
  chunk-level fuses can't tell an act tail from a ckpt tail. These
  fire in ``write``/``readinto`` — above chunking, one fault per call.
* **Dead paths** (``dead_paths`` / :meth:`kill_path`): every chunk op
  landing on a listed path raises permanent EIO — a persistently dead
  DEVICE, the input to the drain-and-failover machinery.
* **Probabilistic chaos** (:class:`ChaosSpec`): seeded, lock-guarded
  RNG; per-op transient errors (EAGAIN — the engine's retry loop
  absorbs them), latency spikes (sleep on the owning channel only),
  torn writes (only a prefix of the chunk lands) and bit flips (one
  flipped bit lands). The torn/flip corruptions land ON DISK while the
  caller's buffer — and therefore the recorded CRC — stays intact, so
  ``IOConfig.integrity`` verification catches them at the next read.

Transient chaos (``error_rate`` + ``latency_rate`` alone) composes
with retries into BITWISE-identical training: a retried chunk op moves
the same bytes to the same slot, and route/path meters are recorded at
submit time, once, above the retry loop.
"""
from __future__ import annotations

import dataclasses
import errno
import random
import threading
import time
from typing import Dict, Optional, Set

from repro_torch.io.backend import StripedFiles


@dataclasses.dataclass
class ChaosSpec:
    """Probabilistic per-op fault rates (all default 0 = no chaos).

    * ``error_rate`` — probability a chunk op raises a TRANSIENT fault
      (``OSError(EAGAIN)``) before touching the device. The engine's
      bounded retry absorbs these; size ``IOConfig.retries`` so that
      ``error_rate ** (retries + 1)`` times the op count stays << 1.
    * ``latency_rate`` / ``latency_s`` — probability an op stalls for
      ``latency_s`` before running (a brownout, not a fault).
    * ``torn_write_rate`` — probability a write persists only the first
      half of its bytes (the caller's buffer is NOT modified, so the
      recorded CRC describes the intended bytes and the tear surfaces
      at the next verified read).
    * ``bit_flip_rate`` — probability a write lands with one bit
      flipped (same detection story as a tear).
    * ``seed`` — RNG seed; one seeded stream per ChaosFiles instance,
      lock-guarded because ops roll it from concurrent channel threads.
    """

    error_rate: float = 0.0
    latency_rate: float = 0.0
    latency_s: float = 0.001
    torn_write_rate: float = 0.0
    bit_flip_rate: float = 0.0
    seed: int = 0


class ChaosFiles(StripedFiles):
    """StripedFiles with every fault the batteries need (see the module
    docstring). All knobs default OFF — a fresh ChaosFiles is
    bit-for-bit a StripedFiles."""

    def __init__(self, engine, spec: Optional[ChaosSpec] = None):
        super().__init__(engine)
        self.spec = spec or ChaosSpec()
        self._rng = random.Random(self.spec.seed)
        self._rng_lock = threading.Lock()
        # deterministic countdown fuses (chunk level)
        self.fail_writes = 0
        self.fail_reads = 0
        self.short_reads = 0
        self.ops = 0
        # name-targeted fuses (call level)
        self.fail_name_writes: Dict[str, int] = {}
        self.fail_name_reads: Dict[str, int] = {}
        self.fail_prefix = ""        # one-shot arbitrary-name write fuse
        # scripted device death
        self.dead_paths: Set[int] = set()
        # chaos accounting (reads by tests/benches)
        self.injected = {"transient": 0, "latency": 0, "torn": 0,
                         "flip": 0, "fuse": 0, "dead": 0}

    # -------- compat with the historical DeadPathFiles single knob ----
    @property
    def dead_path(self) -> Optional[int]:
        return next(iter(self.dead_paths)) if self.dead_paths else None

    @dead_path.setter
    def dead_path(self, p: Optional[int]):
        self.dead_paths = set() if p is None else {p}

    def kill_path(self, p: int):
        """Script a device death: every later chunk op on path ``p``
        fails permanently."""
        self.dead_paths.add(p)

    def revive_path(self, p: int):
        self.dead_paths.discard(p)

    # ---------------- helpers ----------------
    def _fd_path(self, fd: int) -> Optional[int]:
        with self._fd_lock:
            for (_, p), f in self._fds.items():
                if f == fd:
                    return p
        return None

    def _roll(self, rate: float) -> bool:
        if rate <= 0.0:
            return False
        with self._rng_lock:
            return self._rng.random() < rate

    def _chaos_gate(self, write: bool):
        """The probabilistic pre-op effects shared by reads and writes:
        maybe stall, maybe raise a transient fault."""
        sp = self.spec
        if self._roll(sp.latency_rate):
            self.injected["latency"] += 1
            time.sleep(sp.latency_s)
        if self._roll(sp.error_rate):
            self.injected["transient"] += 1
            raise OSError(errno.EAGAIN,
                          "injected transient "
                          + ("write" if write else "read") + " fault")

    # ---------------- raw chunk ops ----------------
    def _pwrite(self, fd, mv, off):
        self.ops += 1
        p = self._fd_path(fd)
        if p is not None and p in self.dead_paths:
            self.injected["dead"] += 1
            raise OSError(errno.EIO, "injected dead-path write fault")
        if self.fail_writes > 0:
            self.fail_writes -= 1
            self.injected["fuse"] += 1
            raise OSError(errno.EIO, "injected write fault")
        self._chaos_gate(write=True)
        sp = self.spec
        if self._roll(sp.torn_write_rate) and len(mv) > 1:
            # persist only a prefix; the caller's buffer (and any CRC
            # computed from it) still describes the INTENDED bytes
            self.injected["torn"] += 1
            super()._pwrite(fd, mv[:len(mv) // 2], off)
            return
        if self._roll(sp.bit_flip_rate) and len(mv) > 0:
            self.injected["flip"] += 1
            buf = bytearray(mv)
            with self._rng_lock:
                i = self._rng.randrange(len(buf))
                b = self._rng.randrange(8)
            buf[i] ^= 1 << b
            super()._pwrite(fd, memoryview(buf), off)
            return
        super()._pwrite(fd, mv, off)

    def _pread(self, fd, mv, off):
        self.ops += 1
        p = self._fd_path(fd)
        if p is not None and p in self.dead_paths:
            self.injected["dead"] += 1
            raise OSError(errno.EIO, "injected dead-path read fault")
        if self.fail_reads > 0:
            self.fail_reads -= 1
            self.injected["fuse"] += 1
            raise OSError(errno.EIO, "injected read fault")
        if self.short_reads > 0:
            self.short_reads -= 1
            return max(0, super()._pread(fd, mv, off) // 2)
        self._chaos_gate(write=False)
        return super()._pread(fd, mv, off)

    # ---------------- name-targeted call-level fuses ----------------
    def _name_fuse(self, fuses: Dict[str, int], name: str) -> bool:
        for prefix, n in fuses.items():
            if n > 0 and name.startswith(prefix):
                fuses[prefix] = n - 1
                self.injected["fuse"] += 1
                return True
        return False

    def write(self, name, data_u8, byte_lo, priority):
        if self._name_fuse(self.fail_name_writes, name):
            raise OSError(errno.EIO, "injected write fault")
        if self.fail_prefix and name.startswith(self.fail_prefix):
            self.fail_prefix = ""
            self.injected["fuse"] += 1
            raise OSError(errno.EIO, "injected write fault")
        return super().write(name, data_u8, byte_lo, priority)

    def readinto(self, name, out_u8, byte_lo, priority):
        if self._name_fuse(self.fail_name_reads, name):
            raise OSError(errno.EIO, "injected read fault")
        return super().readinto(name, out_u8, byte_lo, priority)


def install_chaos(ssd, spec: Optional[ChaosSpec] = None) -> ChaosFiles:
    """Swap an :class:`repro_torch.offload.stores.SSDStore`'s backend for a
    ``ChaosFiles`` (closing the clean one) and return it — the one-line
    hook tests, benches and the quickstart use:

        files = install_chaos(eng.ssd, ChaosSpec(error_rate=0.05))
    """
    ssd.files.close()
    files = ChaosFiles(ssd.engine, spec)
    ssd.files = files
    return files
