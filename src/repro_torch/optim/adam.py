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


#: elements of a leaf updated at a time: bounds the update's f32
#: temporaries (a 1.05 B-element embedding would hold ~7 x 4.2 GB at once)
_LEAF_CHUNK = 1 << 26


def _update_leaf_(p, g, m, v, step: int, cfg: AdamConfig):
    """:func:`_adam_update` written back into ``p``, ``m``, ``v``
    (contiguous), ``_LEAF_CHUNK`` elements at a time: the update is
    element-wise, so the pieces compute the bits of the whole leaf."""
    pf, gf, mf, vf = p.view(-1), g.reshape(-1), m.view(-1), v.view(-1)
    for lo in range(0, pf.numel(), _LEAF_CHUNK):
        sl = slice(lo, lo + _LEAF_CHUNK)
        p2, m2, v2 = _adam_update(pf[sl], gf[sl], mf[sl], vf[sl], step, cfg)
        pf[sl].copy_(p2)
        mf[sl].copy_(m2)
        vf[sl].copy_(v2)


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


def global_norm(grads, *, mesh=None, specs=None) -> torch.Tensor:
    """The L2 norm over every element of ``grads``. Sharded (``mesh`` and
    the leaves' ``specs``): each leaf is this rank's shard, replicated
    over the axes its spec does not name, so the squares are summed over
    the axes each leaf is split over, and every element counts once."""
    if mesh is None:
        return torch.sqrt(sum(torch.sum(g.float() ** 2)
                              for g in tree.leaves(grads)))
    from repro_torch.launch import collectives as coll
    from repro_torch.launch.shardings import split_axes
    by_axes: dict = {}
    for g, s in zip(tree.leaves(grads), tree.leaves(specs)):
        axes = split_axes(s, mesh)
        sq = torch.sum(g.float() ** 2)
        by_axes[axes] = by_axes[axes] + sq if axes in by_axes else sq
    return torch.sqrt(sum(coll.all_reduce(v, mesh, axes) if axes else v
                          for axes, v in by_axes.items()))


def clip_by_global_norm(grads, max_norm: float, *, mesh=None, specs=None):
    """Returns (clipped grads, clip_coef<=1, raw norm); sharded as
    :func:`global_norm`."""
    n = global_norm(grads, mesh=mesh, specs=specs)
    coef = torch.clamp(max_norm / torch.clamp_min(n, 1e-12), max=1.0)
    return tree.tree_map(lambda g: g.float() * coef, grads), coef, n
