"""Mixed-precision Adam (paper §2.1/§2.2 conventions), in torch.

Each weight element carries three full-precision optimizer states —
master parameter, momentum, variance. Forward/backward use the
low-precision (bf16) parameters; gradients are accumulated in f32.
The same math as the reference's ``optim.adam``; state lives on
whatever device the parameters do.

Where the reference returns a new state, the port updates the state's
master/m/v tensors IN PLACE, one leaf at a time, and returns a state
holding the same tensors: at GPT-65B width the f32 state of two layers
and the head is ~29 GB, and a functional update would hold two copies
of it on the card. A state must therefore not be shared by two
trajectories.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from repro_torch import tree


class AdamState(NamedTuple):
    master: Any   # f32 tree (master parameters)
    m: Any        # f32 tree
    v: Any        # f32 tree
    step: int     # completed optimizer steps


@dataclasses.dataclass(frozen=True)
class AdamConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.0


def init_state(params) -> AdamState:
    return AdamState(
        master=tree.tree_map(lambda x: x.float().clone(), params),
        m=tree.tree_map(lambda x: torch.zeros(x.shape, dtype=torch.float32,
                                              device=x.device), params),
        v=tree.tree_map(lambda x: torch.zeros(x.shape, dtype=torch.float32,
                                              device=x.device), params),
        step=0,
    )


def _adam_update(p, g, m, v, step: int, cfg: AdamConfig):
    """One element-wise Adam step on f32 ``p, m, v`` (any shape); the
    bias corrections raise f32 ``b1``/``b2`` to the f32 step, as the
    reference does."""
    g = g.float()
    m2 = cfg.b1 * m + (1 - cfg.b1) * g
    v2 = cfg.b2 * v + (1 - cfg.b2) * g * g
    t = torch.tensor(float(step), dtype=torch.float32, device=p.device)
    b1 = torch.tensor(cfg.b1, dtype=torch.float32, device=p.device)
    b2 = torch.tensor(cfg.b2, dtype=torch.float32, device=p.device)
    mhat = m2 / (1 - b1 ** t)
    vhat = v2 / (1 - b2 ** t)
    p2 = p - cfg.lr * (mhat / (torch.sqrt(vhat) + cfg.eps)
                       + cfg.weight_decay * p)
    return p2, m2, v2


def _update_leaf_(p, g, m, v, step: int, cfg: AdamConfig):
    """:func:`_adam_update` written back into ``p``, ``m``, ``v``."""
    p2, m2, v2 = _adam_update(p, g, m, v, step, cfg)
    p.copy_(p2)
    m.copy_(m2)
    v.copy_(v2)


def lowp_params(master, compute_dtype):
    """The low-precision parameters cast from (never aliasing) the f32
    masters."""
    return tree.tree_map(lambda p: p.to(compute_dtype, copy=True), master)


def apply_update(state: AdamState, grads, cfg: AdamConfig,
                 compute_dtype=torch.bfloat16):
    """Full optimizer step, in place on the state's tensors. Returns (new
    low-precision params, the state at the next step)."""
    step = state.step + 1
    for p, g, m, v in zip(tree.leaves(state.master), tree.leaves(grads),
                          tree.leaves(state.m), tree.leaves(state.v)):
        _update_leaf_(p, g, m, v, step, cfg)
    return (lowp_params(state.master, compute_dtype),
            state._replace(step=step))


def global_norm(grads) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(g.float() ** 2)
                          for g in tree.leaves(grads)))


def clip_by_global_norm(grads, max_norm: float):
    """Returns (clipped grads, clip_coef<=1, raw norm)."""
    n = global_norm(grads)
    coef = torch.clamp(max_norm / torch.clamp_min(n, 1e-12), max=1.0)
    return tree.tree_map(lambda g: g.float() * coef, grads), coef, n
