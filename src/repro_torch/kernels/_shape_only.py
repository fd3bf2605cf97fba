"""The kernels' shape-only path for ``meta`` tensors (the dry-run).

A wrapper given ``meta`` tensors launches nothing and runs no plain
version: it returns empty outputs of the kernel's shapes and dtypes and
reports, here, the work the call stands for — its FLOPs by a closed form
and the bytes of its inputs and outputs — to whatever counts it
(``launch.cost.CostCounter`` installs the tally). CUDA tensors still
launch the kernel or raise; CPU tensors still run the plain version.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

#: the active tally ``(flops, nbytes) -> None``, or None (nothing counts)
_tally: Optional[Callable[[float, float], None]] = None


def set_tally(fn: Optional[Callable[[float, float], None]]) -> None:
    global _tally
    _tally = fn


def nbytes(*tensors: torch.Tensor) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def record(flops: float, inputs, outputs) -> None:
    """One shape-only call: ``flops`` and the bytes of ``inputs`` read
    once and ``outputs`` written once."""
    if _tally is not None:
        _tally(float(flops), float(nbytes(*inputs) + nbytes(*outputs)))
