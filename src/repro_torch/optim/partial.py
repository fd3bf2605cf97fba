"""α-delayed partial optimizer step (GreedySnake §4.4), in torch.

Adam is element-wise, so each tensor can be partitioned into an "early"
fraction (1-α), updated right after its layer's backward pass, and a
"late" fraction α, deferred to just before the layer's forward pass in
the NEXT iteration. Both fractions use the same gradients and the same
step counter, so the composition is exactly one standard Adam step —
split in time, not in math (bit-equal in f32).

The partition is a static flat-index split at k = round((1-α)·numel)
per leaf, as in the reference's ``optim.partial``. As ``optim.adam``,
the fractions update the state's tensors in place.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch import tree
from repro_torch.optim.adam import (AdamConfig, AdamState, _update_leaf_,
                                    lowp_params)


class DelayedAdamState(NamedTuple):
    adam: AdamState
    pending: Any          # f32 grads retained for the late fraction
    has_pending: bool     # the first iteration has none


def init_delayed(adam_state: AdamState, grads_like) -> DelayedAdamState:
    zeros = tree.tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                                device=g.device), grads_like)
    return DelayedAdamState(adam_state, zeros, False)


def _split_k(x: torch.Tensor, alpha: float) -> int:
    return int(round((1.0 - alpha) * x.numel()))


def _apply_fraction(state: AdamState, grads, cfg: AdamConfig, alpha: float,
                    which: str, step: int):
    """Update the early [0,k) or late [k,numel) fraction of every leaf,
    in place on flat views of the state's (contiguous) tensors."""
    for p, g, m, v in zip(tree.leaves(state.master), tree.leaves(grads),
                          tree.leaves(state.m), tree.leaves(state.v)):
        k = _split_k(p, alpha)
        lo, hi = (0, k) if which == "early" else (k, p.numel())
        if hi > lo:
            _update_leaf_(p.view(-1)[lo:hi], g.reshape(-1)[lo:hi],
                          m.view(-1)[lo:hi], v.view(-1)[lo:hi], step, cfg)


def flush_late(state: DelayedAdamState, cfg: AdamConfig, alpha: float,
               compute_dtype=torch.bfloat16):
    """Apply the deferred α fraction (start of next iteration's forward).

    Returns (fully-updated low-precision params, DelayedAdamState)."""
    adam = state.adam
    if state.has_pending:
        _apply_fraction(adam, state.pending, cfg, alpha, "late", adam.step)
    return (lowp_params(adam.master, compute_dtype),
            DelayedAdamState(adam, state.pending, False))


def apply_early(state: DelayedAdamState, grads, cfg: AdamConfig, alpha: float,
                compute_dtype=torch.bfloat16):
    """Apply the (1-α) fraction right after backward; retain grads for the
    late fraction. Returns (partially-updated params, DelayedAdamState)."""
    adam = state.adam._replace(step=state.adam.step + 1)
    _apply_fraction(adam, grads, cfg, alpha, "early", adam.step)
    pending = tree.tree_map(lambda g: g.float(), grads)
    return (lowp_params(adam.master, compute_dtype),
            DelayedAdamState(adam, pending, True))
