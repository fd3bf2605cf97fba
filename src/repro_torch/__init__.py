"""repro_torch — the PyTorch/CUDA port of the GreedySnake reproduction.

Same module layout and names as the JAX package ``repro`` (the
reference), rewritten on ``torch``: ``repro/models/attention.py`` ↔
``repro_torch/models/attention.py``. This package never imports ``jax``
or anything of ``repro``; the framework-free pieces it needs (configs,
the I/O engine, the schedule IR, the stores, the tracer) are its own
copies.

Slice 1 is the SSD-tiered serving path: ``serve.ServeEngine`` with
per-unit tiered params, tiered KV blocks, the schedule IR and the
three-way byte invariant, on a dense model whose prefill attention runs
the hand-written Hopper kernel ``kernels.flash_attention``.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``
(:func:`resolve_device`); there is no silent CPU fallback.
"""
from __future__ import annotations

import contextlib
import os

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` by default, or whatever
    the caller names; a CUDA device raises when there is no card."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run on the CPU")
    return device


@contextlib.contextmanager
def deterministic(on: bool = True):
    """Deterministic algorithms inside the block when ``on``: a
    bit-for-bit comparison of two runs on the card needs them (the
    embedding's backward accumulates with atomics otherwise). cuBLAS
    reads its workspace setting at its first call, so a process that
    compares runs enters this block before its first product."""
    if not on:
        yield
        return
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(prev)
