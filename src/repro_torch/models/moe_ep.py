"""Expert-parallel MoE with explicit all-to-all dispatch.

The port of the reference's ``models/moe_ep.py``, which runs this
pipeline by hand inside ``jax.shard_map``; here each rank runs it on its
own shard and the all-to-all is a ``torch.distributed`` collective
(``launch.collectives``):

  local router top-k
    -> bucket assignments by owner shard (sort, capacity-bounded)
    -> all_to_all over the expert axis              (tokens -> experts)
    -> local sort-based expert FFN over E/m experts
    -> all_to_all back                               (experts -> tokens)
    -> local weighted combine

Sharding contract (``launch.shardings`` with ``expert_parallel``): x is
this rank's batch slice over ``bax``; ``w_*`` hold this rank's E/m
experts (the expert dim split over ``axis``); router and shared experts
are whole. The transpose of all_to_all is all_to_all, so the backward
pass sends the mirrored token traffic and expert gradients stay on their
shard.

The combine has no atomics: each token's K weighted outputs go back to
the router's (token, k) order and are summed over k, as the port's
``moe_apply`` does; the reference scatter-adds them in owner order (the
same f32 sum at K = 2, rounding apart at larger K).

Enabled by ``set_ep_mesh(mesh)`` (``None`` disables: the single-process
``moe_apply``). Inside a sharded train step without EP, the MoE still
computes the global batch's routing, capacity and load-balance loss, as
the reference's SPMD program does: it gathers the tokens over the batch
axes, runs ``moe_apply`` and keeps its own rows (:func:`sharded_batch`).
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.launch import collectives as coll
from repro_torch.models import moe as moe_lib
from repro_torch.models.mlp import mlp_apply

_EP: Optional[dict] = None     # {"mesh": Mesh, "axis": str, "bax": tuple}
_BATCH: Optional[tuple] = None  # (mesh, batch axes) of a sharded step
_dispatches = 0
#: assignments dropped over either capacity (C1 of an owner shard, C2 of
#: a local expert) on this rank since :func:`reset_dropped`, one count a
#: device, kept on the device (read by :func:`dropped_count`)
_dropped: Dict[torch.device, torch.Tensor] = {}


def set_ep_mesh(mesh, *, axis: str = "model",
                bax: Tuple[str, ...] = ("data", "model")) -> None:
    """Enable expert-parallel dispatch on the bound ``mesh`` (``None``
    disables). ``bax`` are the axes the batch dim of x is sharded over
    (typically all mesh axes, so attention and dense parts stay pure
    FSDP and the all-to-all runs within model rows); ``axis`` is the
    expert axis."""
    global _EP
    if mesh is not None and not mesh.bound:
        raise ValueError(f"expert parallelism needs a bound mesh: {mesh!r}")
    _EP = None if mesh is None else {"mesh": mesh, "axis": axis,
                                     "bax": tuple(bax)}


def ep_enabled() -> bool:
    return _EP is not None


def ep_dispatches() -> int:
    """MoE layers run expert-parallel since :func:`reset_ep_dispatches`
    (forward passes, recomputes included)."""
    return _dispatches


def reset_ep_dispatches() -> None:
    global _dispatches
    _dispatches = 0


def reset_dropped() -> None:
    _dropped.clear()


def dropped_count() -> int:
    """This rank's dropped assignments since the last reset."""
    return sum(int(t) for t in _dropped.values())


@contextlib.contextmanager
def sharded_batch(mesh, axes):
    """Inside: x is this rank's slice of a batch split over ``axes``."""
    global _BATCH
    prev, _BATCH = _BATCH, (mesh, tuple(axes))
    try:
        yield
    finally:
        _BATCH = prev


def stationary_dims(path: str, spec) -> tuple:
    """The dimensions of a parameter leaf that a gather at use leaves
    sharded: under EP, an expert weight's expert dimension."""
    ep = _EP
    if ep is None or "moe/w_" not in path or not len(spec):
        return ()
    return (0,) if spec[0] == ep["axis"] else ()


def _group_by(slot_ids, values, n_slots: int, fill):
    """Scatter values (N, d) into (n_slots+1, d) by slot id (last=trash)."""
    buf = values.new_full((n_slots + 1,) + tuple(values.shape[1:]), fill)
    return buf.index_put((slot_ids,), values)


def _sorted_dispatch(ids, n_buckets: int, capacity: int, *,
                     pads_shift: bool = False):
    """ids: (N,) bucket id per element (-1: none). Returns (order, slot,
    keep): elements sorted by bucket; position within bucket < capacity
    kept; slot = bucket*capacity + pos (trash slot = n_buckets*capacity).

    ``pads_shift`` is the reference's arithmetic instead: its
    ``.at[ids].add`` wraps an id of -1 into the last bucket's count, so a
    bucket's start counts only ids in [0, b) while the sorted order puts
    every -1 first, and each position is shifted by the number of -1 ids
    (in EP's second sort, the empty slots a rank received: at
    deepseek-v2-lite's width they outnumber C2, and every assignment
    drops)."""
    N = ids.shape[0]
    order = torch.argsort(ids, stable=True)
    sorted_ids = ids[order]
    below = torch.searchsorted(sorted_ids, torch.arange(
        n_buckets, dtype=ids.dtype, device=ids.device))     # ids < b
    starts = below - below[0] if pads_shift else below
    pos = torch.arange(N, device=ids.device) - starts[sorted_ids]
    keep = (pos < capacity) & (sorted_ids >= 0) & (sorted_ids < n_buckets)
    slot = torch.where(keep, sorted_ids * capacity + pos,
                       torch.full_like(pos, n_buckets * capacity))
    return order, slot, keep


def _moe_ep_local(params, x, cfg, *, mesh, axis: str,
                  capacity_factor: float, pads_shift: bool):
    """One rank's share. x: (B_loc, S, d)."""
    m = mesh.shape[axis]
    my = mesh.coords[axis]
    B, S, d = x.shape
    T = B * S
    E, K = cfg.num_experts, cfg.moe_top_k
    E_loc = E // m
    dev = x.device

    xf = x.reshape(T, d)
    logits = xf.float() @ params["router"].float()              # (T, E)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, gate_idx = torch.topk(probs, K, dim=-1)
    gate_vals = gate_vals / torch.clamp_min(
        gate_vals.sum(-1, keepdim=True), 1e-9)

    # global aux load-balance loss (Switch-style), averaged over the mesh
    W = mesh.size
    me = probs.mean(dim=0)
    se_all = torch.sort(gate_idx.reshape(-1)).values
    bounds = torch.searchsorted(se_all, torch.arange(E + 1, device=dev,
                                                     dtype=se_all.dtype))
    ce = (bounds[1:] - bounds[:-1]).float() / (T * K)
    me = coll.all_reduce(me, mesh) / W
    ce = coll.all_reduce(ce, mesh) / W
    aux = E * torch.sum(me * ce)

    # ---- stage 1: bucket assignments by OWNER shard ----
    flat_e = gate_idx.reshape(T * K)                 # global expert ids
    flat_t = torch.arange(T * K, device=dev) // K
    flat_g = gate_vals.reshape(T * K)
    owner = flat_e // E_loc
    C1 = max(1, int(math.ceil(T * K / m * capacity_factor)))
    order, slot, keep = _sorted_dispatch(owner, m, C1)
    se, st, sg = flat_e[order], flat_t[order], flat_g[order]

    send_x = _group_by(slot, xf[st], m * C1, 0)[:-1].reshape(m, C1, d)
    send_e = torch.full((m * C1 + 1,), -1, dtype=torch.int32, device=dev)
    send_e = send_e.index_put((slot,), se.to(torch.int32))[:-1]

    # ---- all-to-all: tokens -> expert shards ----
    recv_x = coll.all_to_all(send_x, mesh, axis)                 # (m, C1, d)
    recv_e = coll.all_to_all(send_e, mesh, axis)                 # (m C1,)

    # ---- stage 2: local expert FFN over E_loc experts ----
    rx = recv_x.reshape(m * C1, d)
    re = recv_e.long() - my * E_loc                   # local ids; pads < 0
    re = torch.where((re >= 0) & (re < E_loc), re, torch.full_like(re, -1))
    C2 = max(1, int(math.ceil(m * C1 / E_loc * capacity_factor)))
    order2, slot2, keep2 = _sorted_dispatch(re, E_loc, C2,
                                            pads_shift=pads_shift)
    xe = _group_by(slot2, rx[order2], E_loc * C2, 0)[:-1].reshape(
        E_loc, C2, d)
    n_drop = (~keep).sum() + ((re[order2] >= 0) & ~keep2).sum()
    _dropped[dev] = _dropped[dev] + n_drop if dev in _dropped else n_drop
    ye = moe_lib._expert_ffn(params, xe, cfg.act).reshape(E_loc * C2, d)
    ye = torch.cat([ye, ye.new_zeros((1, d))])
    # un-sort back to received order (dropped slots contribute 0)
    out = ye.new_zeros((m * C1, d)).index_put(
        (order2,), ye[slot2] * keep2[:, None].to(ye.dtype))

    # ---- all-to-all back: expert outputs -> token owners ----
    back = coll.all_to_all(out.reshape(m, C1, d), mesh, axis)
    back = torch.cat([back.reshape(m * C1, d), back.new_zeros((1, d))])

    # ---- local combine, in the router's (token, k) order ----
    contrib = back[slot] * (sg * keep).to(back.dtype)[:, None]
    unsorted = torch.empty_like(contrib).index_put((order,), contrib)
    y = unsorted.float().reshape(T, K, d).sum(dim=1)
    y = y.to(x.dtype).reshape(B, S, d)

    if cfg.num_shared_experts:
        y = y + mlp_apply(params["shared"], x, cfg.act)
    return y, aux


def moe_apply_ep(params, x, cfg, *, capacity_factor: float = 1.25,
                 reference_positions: bool = False
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Expert-parallel MoE on this rank's shard (requires set_ep_mesh):
    ``params``' ``w_*`` hold this rank's E/m experts, x its batch slice.
    Returns (this rank's y, the mesh-wide aux loss).
    ``reference_positions`` drops as the reference's ``moe_apply_ep``
    does (:func:`_sorted_dispatch`'s ``pads_shift``), for holding the
    rest of the pipeline to it where assignments drop."""
    global _dispatches
    ep = _EP
    if ep is None:
        raise RuntimeError("moe_apply_ep needs set_ep_mesh(mesh) first")
    mesh, axis = ep["mesh"], ep["axis"]
    m = mesh.shape[axis]
    for k, w in params.items():
        if k.startswith("w_") and w.shape[0] * m != cfg.num_experts:
            raise ValueError(
                f"{k} holds {w.shape[0]} experts; expert parallelism over "
                f"{axis} ({m} ranks) needs this rank's "
                f"{cfg.num_experts // m} of {cfg.num_experts}")
    _dispatches += 1
    return _moe_ep_local(params, x, cfg, mesh=mesh, axis=axis,
                         capacity_factor=capacity_factor,
                         pads_shift=reference_positions)


def _moe_global(params, x, cfg, capacity_factor):
    """``moe_apply`` over the batch gathered across the step's batch
    axes; this rank's rows of y, and the global aux loss."""
    mesh, axes = _BATCH
    xg = coll.all_gather(x, 0, mesh, axes)
    y, aux = moe_lib.moe_apply(params, xg, cfg,
                               capacity_factor=capacity_factor)
    i = mesh.axes_index(axes)
    return y.narrow(0, i * x.shape[0], x.shape[0]), aux


def moe_dispatch(params, x, cfg, *, capacity_factor: float = 1.25
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """EP when enabled and the experts divide over the expert axis; in a
    sharded step otherwise the global batch's ``moe_apply``; else
    ``moe_apply``."""
    ep = _EP
    if ep is not None:
        m = ep["mesh"].shape[ep["axis"]]
        if cfg.num_experts % m == 0:
            if _BATCH is not None and _BATCH[1] != ep["bax"]:
                raise ValueError(
                    f"the step's batch is split over {_BATCH[1]}; "
                    f"expert parallelism was set for {ep['bax']}")
            return moe_apply_ep(params, x, cfg,
                                capacity_factor=capacity_factor)
    if _BATCH is not None:
        return _moe_global(params, x, cfg, capacity_factor)
    return moe_lib.moe_apply(params, x, cfg, capacity_factor=capacity_factor)
