"""Host Adam for the offload engine — the analogue of ZeRO-Infinity's
``cpu_adam`` that GreedySnake reuses.

``CpuAdam.update`` runs one fused pass of ``csrc/cpu_adam.cpp`` (built
with the system C++ compiler at first use, ``kernels/_build.py``) over
blocks of ``BLOCK`` elements on one process-wide pool of threads, so
concurrent calls (several I/O workers, data-parallel ranks in one
process) share the pool's threads instead of each starting their own.
Every element goes through the same code with one IEEE f32 rounding per
operation, in the order of the f32 numpy formula the tests hold it
against, so the bits are the same for any block size, thread count or
chunk/partition ratio (the paper's §6.5 reproducibility point) and the
α-delayed partial updates compose to one whole update.
"""
from __future__ import annotations

import ctypes
import functools
import os
import threading
from concurrent.futures import ThreadPoolExecutor, wait

import numpy as np

from repro_torch.kernels import _build

#: elements of one block: 4 MiB of each of master, m, v and the gradient
BLOCK = 1 << 20

#: CPUs left to the rest of the process while an update runs: the
#: executor's thread, and the I/O work (reads, writes, casts) beside it
_HEADROOM = 2

_pool: ThreadPoolExecutor | None = None
_pool_lock = threading.Lock()


def pool_width() -> int:
    """Threads of the shared pool: the CPUs this process may run on, less
    the headroom."""
    return max(1, len(os.sched_getaffinity(0)) - _HEADROOM)


def _shared_pool() -> ThreadPoolExecutor:
    global _pool
    with _pool_lock:
        if _pool is None:
            _pool = ThreadPoolExecutor(pool_width(),
                                       thread_name_prefix="cpu-adam")
        return _pool


def _forget_pool():
    # a forked child holds none of its parent's threads
    global _pool, _pool_lock
    _pool, _pool_lock = None, threading.Lock()


os.register_at_fork(after_in_child=_forget_pool)


@functools.cache
def _block_fn():
    f = _build.load("cpu_adam").cpu_adam_block
    f.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong]
                  + [ctypes.c_float] * 9 + [ctypes.c_int])
    f.restype = None
    return f


def _check_state(name: str, a: np.ndarray, hi: int):
    if not (isinstance(a, np.ndarray) and a.ndim == 1
            and a.dtype == np.float32 and a.flags.c_contiguous
            and a.flags.writeable):
        raise ValueError(f"CpuAdam: {name} must be a writeable, contiguous, "
                         f"flat float32 array")
    if hi > a.size:
        raise ValueError(f"CpuAdam: [lo, hi) ends at {hi}, past the "
                         f"{a.size} elements of {name}")


class CpuAdam:
    def __init__(self, lr=3e-4, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.0):
        self.lr, self.b1, self.b2, self.eps, self.wd = lr, b1, b2, eps, weight_decay
        self._local = threading.local()

    @property
    def last_threads(self) -> int:
        """Threads that ran blocks of the calling thread's last update."""
        return getattr(self._local, "threads", 0)

    def update(self, master: np.ndarray, m: np.ndarray, v: np.ndarray,
               grad: np.ndarray, step: int,
               lo: int = 0, hi: int | None = None) -> None:
        """In-place Adam on flat f32 arrays, elements [lo, hi). A gradient
        of another dtype is converted to f32 first."""
        hi = master.size if hi is None else hi
        if hi <= lo:
            return
        if lo < 0:
            raise ValueError(f"CpuAdam: lo {lo} is negative")
        for name, a in (("master", master), ("m", m), ("v", v)):
            _check_state(name, a, hi)
        if grad.ndim != 1 or hi > grad.size:
            raise ValueError("CpuAdam: grad must be flat and hold [lo, hi)")
        g = np.ascontiguousarray(grad[lo:hi], dtype=np.float32)
        segs = (master[lo:hi], m[lo:hi], v[lo:hi], g)
        for i in range(4):
            for j in range(i):
                if np.may_share_memory(segs[i], segs[j]):
                    raise ValueError("CpuAdam: master, m, v and grad must "
                                     "not overlap")
        # computed in double, rounded to f32 by ctypes as numpy rounds a
        # Python scalar
        b1, b2 = float(self.b1), float(self.b2)
        scal = (b1, b2, 1 - b1, 1 - b2, 1 - b1 ** step, 1 - b2 ** step,
                float(self.eps), float(self.wd), float(self.lr),
                int(bool(self.wd)))
        ptrs = [s.ctypes.data for s in segs]
        fn = _block_fn()
        n = hi - lo

        def block(i: int) -> int:
            k = min(BLOCK, n - i)
            fn(*(p + 4 * i for p in ptrs), k, *scal)
            return threading.get_ident()

        if n <= BLOCK:
            block(0)
            self._local.threads = 1
            return
        pool = _shared_pool()
        futs = [pool.submit(block, i) for i in range(0, n, BLOCK)]
        # the arrays stay referenced until the last block has run; then
        # every future is read, so a fault in any block raises here
        wait(futs)
        self._local.threads = len({f.result() for f in futs})
