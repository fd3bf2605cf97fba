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

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` by default (raises
    when there is no card), or whatever the caller names."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA device by default and none is "
                "available; pass device='cpu' to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)
