"""Host (numpy) Adam for the offload engine — the analogue of
ZeRO-Infinity's ``cpu_adam`` that GreedySnake reuses.

All computation is uniformly vectorised (no scalar tail handling), which
is the paper's §6.5 reproducibility point: loss is bit-identical across
different chunk/partition ratios because every element goes through the
same vectorised code path. Supports partial (chunk-range) updates for the
α-delayed optimizer step.
"""
from __future__ import annotations

import numpy as np


class CpuAdam:
    def __init__(self, lr=3e-4, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.0):
        self.lr, self.b1, self.b2, self.eps, self.wd = lr, b1, b2, eps, weight_decay

    def update(self, master: np.ndarray, m: np.ndarray, v: np.ndarray,
               grad: np.ndarray, step: int,
               lo: int = 0, hi: int | None = None) -> None:
        """In-place Adam on flat f32 arrays, elements [lo, hi)."""
        hi = master.size if hi is None else hi
        if hi <= lo:
            return
        p = master[lo:hi]
        g = grad[lo:hi].astype(np.float32)
        m_ = m[lo:hi]
        v_ = v[lo:hi]
        np.multiply(m_, self.b1, out=m_)
        m_ += (1 - self.b1) * g
        np.multiply(v_, self.b2, out=v_)
        v_ += (1 - self.b2) * (g * g)
        bc1 = 1 - self.b1 ** step
        bc2 = 1 - self.b2 ** step
        denom = np.sqrt(v_ / bc2) + self.eps
        upd = (m_ / bc1) / denom
        if self.wd:
            upd = upd + self.wd * p
        p -= self.lr * upd
