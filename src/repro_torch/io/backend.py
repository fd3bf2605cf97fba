"""Chunked, striped flat-tensor files across N SSD paths, with a
per-tensor chunk-location table so chunk->path assignment is a
scheduled decision, not a layout constant.

Baseline layout (MLP-Offload-style round robin): a tensor of
``nbytes`` is cut into chunks of ``chunk_bytes``; chunk ``i`` DEFAULTS
to path ``i % P`` at slot ``i // P`` of that path's stripe file
(``<path>/<name>.s<p>.bin``, file offset = slot * chunk_bytes). Under
``path_policy="static"`` that default is the whole story — the layout
is bit-for-bit the classic static striping and no placement state is
ever created.

Under the dynamic policies ("weighted"/"backlog") every FULL-chunk
write asks :meth:`IOEngine.choose_path` where the chunk should land
*now* (rate-weighted / least-backlogged path) and records the decision
in the tensor's chunk-location table: ``chunk -> (path, slot)``. Reads
and partial writes follow the recorded map, falling back to the static
default for chunks never dynamically placed — so a tensor written
under "static" stays readable after a policy flip and vice versa.
Slots for re-placed chunks come from a per-(tensor, path) allocation
cursor that starts past the stripe file's current end and only ever
moves forward, and a claims map tracks slot ownership so a dynamic
allocation can never collide with a chunk still on its static slot.
Slots vacated by a re-placement are deliberately NEVER reused: an op
targeting the old slot may still be in flight (chunk ops from
overlapping writes of one tensor interleave on the path channels), so
handing the slot to another chunk would let that stale op corrupt the
new tenant after the fact. Orphaning the slot instead means a stale op
can only ever touch bytes its own chunk used to own — the worst case
degrades to the same-offset version race static striping always had,
at the cost of stripe-file growth when placement flips a chunk between
paths. Only full-chunk writes re-place: a short last chunk or a ranged
partial write sticks to wherever the chunk already lives (moving it
would require a read-modify-write of bytes the caller didn't provide).

The table is persisted as a JSON sidecar next to the first path's
stripe file (``<paths[0]>/<name>.map.json``, written atomically via
temp + rename after the chunk writes it describes have completed) and
lazily reloaded on reopen, so placement survives process restarts.
Static-only, integrity-off runs produce zero sidecars.

Integrity (``IOConfig.integrity``): every COMPLETE-chunk write — one
whose buffer is authoritative for every byte the chunk will hold
(``lo == c*C`` and the span reaches the chunk boundary or the tensor's
known end) — records the CRC32C of the intended bytes in the sidecar,
and every complete-chunk read verifies the stored bytes against it,
raising :class:`repro_torch.io.integrity.IntegrityError` on mismatch. The
checksum is computed from the WRITE buffer, not read back from disk, so
a torn write (device persisted only a prefix) or a flipped bit is
caught at the next read instead of training on garbage. Partial writes
drop the chunk's recorded CRC (the buffer can't vouch for bytes it
doesn't carry); partial reads skip verification.

Fault recovery on the write path: a chunk op error that survives the
engine's transient-retry loop surfaces here, and — when the chunk is
complete and another path exists — the chunk is re-placed on a
surviving path (``IOEngine.failover_path``) and re-written from the
caller's authoritative buffer, recording the move in the location
table. A path at ``PATH_FAIL_DRAIN_THRESHOLD`` consecutive failures is
additionally avoided PRE-emptively for new complete-chunk writes under
EVERY policy, static included (a dead device is a fault condition, not
a layout choice). Reads are never rerouted: a chunk's only copy lives
where the table says, so a dead-path read fails loudly — data is
declared irrecoverable rather than silently substituted.

All byte movement is positioned I/O (``pread``/``pwritev`` on cached
fds), submitted as one chunk op per chunk on the owning path's channel
— so a P-path store keeps P threads busy in parallel, and a
higher-priority tensor's chunks overtake a lower-priority one's in
each channel's heap. Bandwidth pacing applies per chunk before the
syscall: the route cap (``cpu->ssd`` / ``ssd->cpu``) and the owning
path's device cap (``IOConfig.path_bandwidth``) both, when configured.
"""
from __future__ import annotations

import json
import os
import threading
from typing import Dict, List, Optional, Set, Tuple

import numpy as np

from repro_torch.io.engine import IOEngine, IOPriority
from repro_torch.io.integrity import IntegrityError, crc32c


def _mangle(name: str) -> str:
    return name.replace("/", "_")


class StripedFiles:
    def __init__(self, engine: IOEngine):
        self.engine = engine
        self.paths = engine.paths
        self.chunk = int(engine.chunk_bytes)
        self._fds: Dict[Tuple[str, int], int] = {}
        self._fd_lock = threading.Lock()
        # placement state, all guarded by _map_lock:
        #   _tables[name]: chunk -> (path, slot) overrides (absent chunk
        #       = static default); _claims[name]: (path, slot) -> chunk
        #       for every slot a write has claimed THIS process — the
        #       collision guard between static-default slots and
        #       allocated ones; _cursors[name][p]: next never-used slot
        #       (init lazily from stripe file size + live claims).
        #       Slots vacated by re-placement are orphaned, never
        #       recycled (see the module docstring).
        self._map_lock = threading.Lock()
        self._tables: Dict[str, Dict[int, Tuple[int, int]]] = {}
        self._claims: Dict[str, Dict[Tuple[int, int], int]] = {}
        self._cursors: Dict[str, List[Optional[int]]] = {}
        self._map_checked: Set[str] = set()
        # integrity state (also under _map_lock): _crcs[name][chunk] is
        # the CRC32C of the chunk's intended bytes, recorded at write;
        # _hiwater[name] is the highest byte offset ever written (or
        # loaded from the sidecar) — the "known end" that makes a short
        # last chunk count as COMPLETE for checksum purposes.
        self.integrity = bool(getattr(engine.config, "integrity", False))
        self._crcs: Dict[str, Dict[int, int]] = {}
        self._hiwater: Dict[str, int] = {}

    # ---------------- fd cache ----------------
    def _fd(self, name: str, p: int) -> int:
        key = (name, p)
        with self._fd_lock:
            fd = self._fds.get(key)
            if fd is None:
                path = os.path.join(self.paths[p],
                                    _mangle(name) + f".s{p}.bin")
                fd = os.open(path, os.O_RDWR | os.O_CREAT, 0o644)
                self._fds[key] = fd
            return fd

    # ---------------- raw chunk ops ----------------
    # The single choke point every chunk's bytes pass through. Kept as
    # overridable methods so a harness can inject faults (short reads,
    # EIO, stalls) under the full engine stack — the fault-injection
    # test battery subclasses StripedFiles and flips these.
    def _pwrite(self, fd: int, mv: memoryview, off: int) -> None:
        os.pwritev(fd, [mv], off)

    def _pread(self, fd: int, mv: memoryview, off: int) -> int:
        return os.preadv(fd, [mv], off)

    # ---------------- chunk-location table ----------------
    def _map_path(self, name: str) -> str:
        return os.path.join(self.paths[0], _mangle(name) + ".map.json")

    def _load_sidecar(self, name: str):
        """Load the sidecar once per tensor: the placement table plus,
        when present, the per-chunk CRCs and the byte high-water mark.
        Caller holds _map_lock."""
        if name in self._map_checked:
            return
        self._map_checked.add(name)
        try:
            with open(self._map_path(name)) as f:
                doc = json.load(f)
        except FileNotFoundError:
            return
        if (doc.get("chunk_bytes") != self.chunk
                or doc.get("n_paths") != len(self.paths)):
            raise ValueError(
                f"stale chunk map for {name!r}: written with "
                f"chunk_bytes={doc.get('chunk_bytes')} over "
                f"{doc.get('n_paths')} path(s), reopened with "
                f"chunk_bytes={self.chunk} over "
                f"{len(self.paths)} path(s)")
        m = doc.get("map") or {}
        if m:
            t = {int(c): (int(p), int(s)) for c, (p, s) in m.items()}
            self._tables[name] = t
            self._claims[name] = {ps: c for c, ps in t.items()}
        crcs = doc.get("crc") or {}
        if crcs:
            self._crcs[name] = {int(c): int(v) for c, v in crcs.items()}
        nb = doc.get("nbytes")
        if nb is not None:
            self._hiwater[name] = max(self._hiwater.get(name, 0), int(nb))

    def _table(self, name: str) -> Optional[Dict[int, Tuple[int, int]]]:
        """The tensor's placement table, lazily loading the sidecar the
        first time the tensor is touched. Caller holds _map_lock."""
        t = self._tables.get(name)
        if t is None:
            self._load_sidecar(name)
            t = self._tables.get(name)
        return t

    def _persist(self, name: str):
        """Atomically write the sidecar (temp + rename). Called after
        the chunk writes a table/CRC mutation describes have completed,
        so a persisted slot always has its bytes on disk and a persisted
        checksum always covers bytes that were sent."""
        with self._map_lock:
            t = self._tables.get(name)
            crcs = self._crcs.get(name) if self.integrity else None
            if not t and not crcs:
                return
            doc = {"chunk_bytes": self.chunk, "n_paths": len(self.paths),
                   "map": {str(c): list(ps)
                           for c, ps in sorted((t or {}).items())}}
            if self.integrity:
                doc["crc"] = {str(c): v
                              for c, v in sorted((crcs or {}).items())}
                doc["nbytes"] = self._hiwater.get(name, 0)
        target = self._map_path(name)
        tmp = target + ".tmp"
        with open(tmp, "w") as f:
            json.dump(doc, f)
        os.replace(tmp, target)

    def _alloc_slot(self, name: str, p: int) -> int:
        """An unclaimed, never-dynamically-used slot on path ``p`` from
        the monotonic allocation cursor. The cursor initializes past
        the stripe file's current end (data from earlier processes /
        completed writes; in-flight slots are covered by the claims
        skip below) and never moves backward — vacated slots are never
        recycled. At EVERY allocation the cursor additionally skips
        slots claimed since it was initialized: a chunk that kept its
        static default ``(c % P, c // P)`` after the cursor passed that
        slot would otherwise be silently overwritten by the next
        dynamic placement on its path. Caller holds _map_lock."""
        cur = self._cursors.setdefault(name, [None] * len(self.paths))
        if cur[p] is None:
            fd = self._fd(name, p)
            cur[p] = (os.fstat(fd).st_size + self.chunk - 1) // self.chunk
        claims = self._claims.get(name) or {}
        slot = cur[p]
        while (p, slot) in claims:
            slot += 1
        cur[p] = slot + 1
        return slot

    def placement(self, name: str, c: int) -> Tuple[int, int]:
        """Where chunk ``c`` of tensor ``name`` lives: the recorded
        table entry, else the static default ``(c % P, c // P)``."""
        with self._map_lock:
            t = self._table(name)
            if t is not None:
                e = t.get(c)
                if e is not None:
                    return e
        P = len(self.paths)
        return c % P, c // P

    # ---------------- per-chunk CRCs (integrity) ----------------
    def _set_crc(self, name: str, c: int, crc: int):
        with self._map_lock:
            self._crcs.setdefault(name, {})[c] = crc

    def _drop_crc(self, name: str, c: int):
        """A partial write touched chunk ``c``: its recorded checksum no
        longer describes the full chunk, so verification must skip it."""
        with self._map_lock:
            crcs = self._crcs.get(name)
            if crcs:
                crcs.pop(c, None)

    def _crc_of(self, name: str, c: int) -> Optional[int]:
        with self._map_lock:
            self._load_sidecar(name)
            crcs = self._crcs.get(name)
            return crcs.get(c) if crcs else None

    def _place_for_write(self, name: str, c: int, full: bool,
                         complete: bool = False) -> Tuple[int, int, bool]:
        """Placement decision for one chunk about to be WRITTEN.
        Returns (path, slot, table_mutated).

        A full chunk under a dynamic policy is re-placed via
        :meth:`IOEngine.choose_path`; anything else sticks to its
        recorded/static location. Either way, a static-default slot
        already owned by a re-placed chunk forces a fresh allocation
        (the collision guard: the cursor starts from the file size, so
        a first-ever dynamic write can hand out slots the tensor's
        *later* chunks would map to statically).

        ``complete`` marks a chunk whose buffer carries every byte the
        chunk will hold; such a chunk headed for a DRAINED path (at the
        consecutive-failure threshold) is rerouted to a survivor
        pre-emptively under every policy — ``full``/dynamic placement
        governs load balancing, ``complete``/drain governs fault
        avoidance, and the two stay separate so partial writes never
        move (the caller's buffer can't re-create bytes it lacks)."""
        eng = self.engine
        P, C = len(self.paths), self.chunk
        dynamic = full and P > 1 and eng.path_policy != "static"
        new_p = eng.choose_path(C) if dynamic else None
        moved_off = None
        with self._map_lock:
            t = self._table(name)
            entry = t.get(c) if t is not None else None
            old = entry if entry is not None else (c % P, c // P)
            claims = self._claims.setdefault(name, {})
            # "ours": unclaimed, or claimed by this very chunk
            ours = claims.get(old, c) == c
            if ((new_p is None or new_p == old[0]) and complete and P > 1
                    and eng.path_drained(old[0])):
                survivor = eng.failover_path({old[0]}, C)
                if survivor is not None:
                    moved_off, new_p = old[0], survivor
            if new_p is None or (new_p == old[0] and ours):
                if ours:
                    if claims.get(old) != c:
                        # record the static claim so the allocation
                        # cursor can never hand this slot out
                        claims[old] = c
                    return old[0], old[1], False
                # static slot stolen by a re-placed chunk: convert this
                # chunk to a fresh slot on its own (static) path
                new_p = old[0]
            slot = self._alloc_slot(name, new_p)
            if t is None:
                t = self._tables[name] = {}
            t[c] = (new_p, slot)
            claims[(new_p, slot)] = c
            if ours:
                # the old slot is orphaned, never recycled: a stale op
                # from an overlapping write may still land there
                claims.pop(old, None)
        if moved_off is not None:
            eng.note_failover(moved_off, new_p, name, c)
        return new_p, slot, True

    # ---------------- bulk ops ----------------
    def _chunk_spans(self, byte_lo: int, byte_hi: int):
        """Yield (chunk_index, lo, hi) per chunk overlapping
        [byte_lo, byte_hi) — lo/hi are tensor-relative byte offsets."""
        C = self.chunk
        for c in range(byte_lo // C, (byte_hi + C - 1) // C):
            lo = max(byte_lo, c * C)
            hi = min(byte_hi, (c + 1) * C)
            if lo < hi:
                yield c, lo, hi

    def _chunk_op(self, name: str, p: int, off: int, mv: memoryview,
                  n: int, c: int, complete: bool, write: bool,
                  route: str):
        """One chunk's channel op: pace, move the bytes, and maintain /
        verify the chunk's CRC when integrity is on. The checksum is
        computed from ``mv`` — the INTENDED bytes — after the pwrite, so
        a torn or corrupted landing mismatches at the next read."""
        eng = self.engine

        def op():
            fd = self._fd(name, p)
            eng.throttle(route, n)
            eng.throttle_path(p, n)
            if write:
                self._pwrite(fd, mv, off)
                if self.integrity:
                    if complete:
                        self._set_crc(name, c, crc32c(mv))
                    else:
                        self._drop_crc(name, c)
            else:
                got = self._pread(fd, mv, off)
                if got != n:
                    raise IOError(
                        f"short read on {name!r} path {p}: "
                        f"{got}/{n} bytes at offset {off}")
                if self.integrity and complete:
                    want = self._crc_of(name, c)
                    if want is not None and crc32c(mv) != want:
                        eng.note_integrity_error(p, name, c)
                        raise IntegrityError(
                            f"CRC32C mismatch on {name!r} chunk {c} "
                            f"(path {p}): stored bytes do not match "
                            f"the recorded checksum")
        return op

    def _failover_write(self, name: str, c: int, lo: int,
                        mv: memoryview, n: int, failed: int, route: str,
                        priority: IOPriority):
        """Re-home one COMPLETE chunk whose write just failed
        permanently: allocate a slot on a surviving path, point the
        table there, and re-write from the caller's authoritative
        buffer. Tries every survivor in turn; raises the last error when
        none accepts the bytes (table then points at the last attempt —
        the same bytes-were-SENT discipline as partial-failure
        persists)."""
        eng = self.engine
        C = self.chunk
        exclude = {failed}
        last: Optional[BaseException] = None
        while True:
            q = eng.failover_path(exclude, n)
            if q is None:
                if last is not None:
                    raise last
                raise IOError(
                    f"no surviving path for {name!r} chunk {c}: all "
                    f"{len(self.paths)} path(s) failed")
            with self._map_lock:
                t = self._table(name)
                entry = t.get(c) if t is not None else None
                old = (entry if entry is not None
                       else (c % len(self.paths), c // len(self.paths)))
                claims = self._claims.setdefault(name, {})
                ours = claims.get(old, c) == c
                slot = self._alloc_slot(name, q)
                if t is None:
                    t = self._tables[name] = {}
                t[c] = (q, slot)
                claims[(q, slot)] = c
                if ours:
                    claims.pop(old, None)
            off = slot * C + (lo - c * C)
            fut = eng.submit_chunk(
                q, self._chunk_op(name, q, off, mv, n, c, True, True,
                                  route),
                priority, route=route, nbytes=n)
            try:
                fut.result()
            except BaseException as e:
                last = e
                exclude.add(q)
                continue
            eng.note_failover(failed, q, name, c)
            return

    def _positioned(self, name: str, data_u8: np.ndarray, byte_lo: int,
                    write: bool, route: str, priority: IOPriority):
        """Chunked read into / write from ``data_u8`` (a uint8 view) that
        occupies tensor bytes [byte_lo, byte_lo + data_u8.nbytes).
        One channel op per chunk, so a higher-priority transfer's chunks
        can overtake this one's mid-flight. Placement is resolved here,
        in the submitting thread (deterministic decision order), before
        the ops fan out to the path channels.

        A write op that fails permanently (past the engine's transient
        retries) on a COMPLETE chunk of a multi-path store falls back to
        :meth:`_failover_write`; every other failure propagates after
        the remaining chunks settle."""
        nbytes = data_u8.nbytes
        if nbytes == 0:
            self._fd(name, 0)        # ensure the tensor exists on disk
            return
        byte_hi = byte_lo + nbytes
        eng = self.engine
        C = self.chunk
        # the sidecar must be loaded BEFORE the high-water mark is read:
        # a fresh backend over existing files (a reopen, or a chaos
        # harness swapped in mid-run) would otherwise see hw=0 and call
        # a partial chunk span "complete" — verifying a partial read
        # against a full-chunk CRC, or recording a partial-chunk CRC
        with self._map_lock:
            self._load_sidecar(name)
            if write:
                hw = max(self._hiwater.get(name, 0), byte_hi)
                self._hiwater[name] = hw
            else:
                hw = self._hiwater.get(name, 0)
        subs: List[tuple] = []
        mutated = False
        for c, lo, hi in self._chunk_spans(byte_lo, byte_hi):
            n = hi - lo
            # "complete": the buffer is authoritative for every byte the
            # chunk will hold — a full chunk, or a short LAST chunk that
            # starts on its boundary and reaches the tensor's known end
            complete = lo == c * C and (n == C or hi >= hw)
            if write:
                p, slot, changed = self._place_for_write(
                    name, c, full=(n == C), complete=complete)
                mutated = mutated or changed
            else:
                p, slot = self.placement(name, c)
            off = slot * C + (lo - c * C)
            mv = memoryview(data_u8[lo - byte_lo:hi - byte_lo])
            fut = eng.submit_chunk(
                p, self._chunk_op(name, p, off, mv, n, c, complete,
                                  write, route),
                priority, route=route, nbytes=n)
            subs.append((fut, c, lo, p, mv, n, complete))
        err = None
        for fut, c, lo, p, mv, n, complete in subs:
            try:
                fut.result()
            except BaseException as e:
                if write and complete and len(self.paths) > 1:
                    try:
                        self._failover_write(name, c, lo, mv, n, p,
                                             route, priority)
                        mutated = True
                        continue
                    except BaseException as e2:
                        err = err or e2
                else:
                    err = err or e
        if mutated or (write and self.integrity):
            # persist even on partial failure: the table describes where
            # the bytes were SENT, and surviving chunks did land there
            self._persist(name)
        if err is not None:
            raise err

    def write(self, name: str, data_u8: np.ndarray, byte_lo: int,
              priority: IOPriority):
        self._positioned(name, data_u8, byte_lo, write=True,
                         route="cpu->ssd", priority=priority)

    def readinto(self, name: str, out_u8: np.ndarray, byte_lo: int,
                 priority: IOPriority):
        self._positioned(name, out_u8, byte_lo, write=False,
                         route="ssd->cpu", priority=priority)

    def delete(self, name: str):
        for p in range(len(self.paths)):
            with self._fd_lock:
                fd = self._fds.pop((name, p), None)
            if fd is not None:
                os.close(fd)
            path = os.path.join(self.paths[p], _mangle(name) + f".s{p}.bin")
            try:
                os.unlink(path)
            except FileNotFoundError:
                pass
        with self._map_lock:
            self._tables.pop(name, None)
            self._claims.pop(name, None)
            self._cursors.pop(name, None)
            self._map_checked.discard(name)
            self._crcs.pop(name, None)
            self._hiwater.pop(name, None)
        try:
            os.unlink(self._map_path(name))
        except FileNotFoundError:
            pass

    def close(self):
        with self._fd_lock:
            fds, self._fds = list(self._fds.values()), {}
        for fd in fds:
            os.close(fd)
