"""Micro-batch splitting for gradient accumulation (paper §2.1)."""
from __future__ import annotations

from repro_torch import tree


def split_microbatches(batch, num_microbatches: int):
    """dict of (B, ...) -> dict of (M, B/M, ...). B must divide evenly."""
    def split(x):
        b = x.shape[0]
        if b % num_microbatches:
            raise ValueError(f"batch {b} does not split into "
                             f"{num_microbatches} micro-batches")
        return x.reshape(num_microbatches, b // num_microbatches,
                         *x.shape[1:])
    return tree.tree_map(split, batch)
