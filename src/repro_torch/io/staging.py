"""Bounded host staging pool for asynchronous spills.

An async offload (e.g. a checkpoint tail headed to SSD) must not keep the
producer's buffer alive until the write completes. The pool hands out a
fixed set of reusable host buffers: the caller memcpys into one, submits
the write, and the completion releases it. With ``nbuf=2`` this is the
classic double-buffer: one buffer drains to SSD while the next fills —
and ``acquire`` blocking when both are busy is the natural backpressure.
"""
from __future__ import annotations

import threading

import numpy as np


class StagedBuffer:
    """A leased staging buffer; ``view`` is the first ``nbytes`` of it.
    Call ``release()`` (idempotent) when the transfer completes."""

    def __init__(self, pool: "StagingPool", data: np.ndarray, nbytes: int,
                 pooled: bool):
        self._pool = pool
        self._data = data
        self._pooled = pooled
        self._released = False
        self.view = data[:nbytes]

    def release(self):
        if self._released:
            return
        self._released = True
        if self._pooled:
            self._pool._put_back(self._data)


class StagingPool:
    def __init__(self, nbuf: int = 2, buf_bytes: int = 1 << 20):
        self.buf_bytes = int(buf_bytes)
        self._free = [np.empty(self.buf_bytes, np.uint8) for _ in range(nbuf)]
        self._cv = threading.Condition()
        self.oversized_allocs = 0   # transfers too big for a pooled buffer

    def acquire(self, nbytes: int) -> StagedBuffer:
        """Lease a buffer of >= nbytes. Requests larger than the pool's
        buffer size get a one-off allocation (counted, not pooled)."""
        if nbytes > self.buf_bytes:
            with self._cv:
                self.oversized_allocs += 1
            return StagedBuffer(self, np.empty(nbytes, np.uint8), nbytes,
                                pooled=False)
        with self._cv:
            while not self._free:
                self._cv.wait()
            data = self._free.pop()
        return StagedBuffer(self, data, nbytes, pooled=True)

    def _put_back(self, data: np.ndarray):
        with self._cv:
            self._free.append(data)
            self._cv.notify()
