"""Collectives over the mesh's axes, with autograd — the port's stand-in
for what XLA SPMD inserts into a sharded program.

* :func:`all_gather` and :func:`reduce_scatter` along one tensor
  dimension over a set of mesh axes, each the other's transpose: the
  gradient of a gathered parameter is reduce-scattered (summed) back to
  its shards, and the other way round.
* :func:`all_to_all` over one axis: the tensor's leading dimension is
  split in one chunk per rank of the axis, chunk ``j`` goes to rank
  ``j``; its transpose is itself.
* :func:`all_reduce` (sum) for the loss, the norm and the gradients of
  replicated leaves; its transpose is itself.

The transposes hold for a program whose objective is the SUM of every
rank's local objective: that is what the sharded train step
differentiates (``core.schedules``), before it divides by the world size.

Every call that moves data adds to a count by kind, the kinds and fields
the reference's ``parse_collectives`` reports from compiled HLO
(``src/repro/launch/dryrun.py``): calls, result bytes and operand bytes,
as this rank sees them. A set of axes of size 1 moves nothing and counts
nothing.

The ops take CUDA tensors as they are: ``gloo`` runs all four on the
card's memory with four ranks on one H100 (``tools/gloo_cuda_probe.py``).
"""
from __future__ import annotations

import copy
from typing import Dict

import torch
import torch.distributed as dist

KINDS = ("all-gather", "reduce-scatter", "all-to-all", "all-reduce")

# torch 2.13 renames the tensor forms to ``*_single`` and warns on the old
# names; torch 2.11 (the card's machine) has only the old ones
_ALL_GATHER = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor
_REDUCE_SCATTER = getattr(dist, "reduce_scatter_single", None) \
    or dist.reduce_scatter_tensor

_ZERO = {"count": 0, "result_bytes": 0, "operand_bytes": 0}
_counts: Dict[str, Dict[str, int]] = {k: dict(_ZERO) for k in KINDS}


def reset_counts() -> None:
    for k in KINDS:
        _counts[k] = dict(_ZERO)


def counts() -> Dict[str, Dict[str, int]]:
    """Calls, result bytes and operand bytes by kind since the last
    :func:`reset_counts`, on this rank."""
    return copy.deepcopy(_counts)


def _count(kind: str, operand: torch.Tensor, result: torch.Tensor) -> None:
    c = _counts[kind]
    c["count"] += 1
    c["operand_bytes"] += operand.numel() * operand.element_size()
    c["result_bytes"] += result.numel() * result.element_size()


def _gather(x, dim: int, mesh, axes) -> torch.Tensor:
    n = mesh.axes_size(axes)
    xs = x.movedim(dim, 0).contiguous()
    out = xs.new_empty((n * xs.shape[0],) + xs.shape[1:])
    _ALL_GATHER(out, xs, group=mesh.group(axes))
    _count("all-gather", xs, out)
    return out.movedim(0, dim)


def _scatter(x, dim: int, mesh, axes) -> torch.Tensor:
    n = mesh.axes_size(axes)
    xs = x.movedim(dim, 0).contiguous()
    if xs.shape[0] % n:
        raise ValueError(f"dimension {dim} of {tuple(x.shape)} does not "
                         f"split over {axes} ({n} ranks)")
    out = xs.new_empty((xs.shape[0] // n,) + xs.shape[1:])
    _REDUCE_SCATTER(out, xs, group=mesh.group(axes))
    _count("reduce-scatter", xs, out)
    return out.movedim(0, dim)


def _a2a(x, mesh, axis: str) -> torch.Tensor:
    xs = x.contiguous()
    out = torch.empty_like(xs)
    dist.all_to_all_single(out, xs, group=mesh.group((axis,)))
    _count("all-to-all", xs, out)
    return out


def _reduce(x, mesh, axes) -> torch.Tensor:
    src = x.detach().contiguous()
    out = src.clone()
    dist.all_reduce(out, group=mesh.group(axes))
    _count("all-reduce", src, out)
    return out


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, mesh, axes):
        ctx.args = (dim, mesh, axes)
        return _gather(x, dim, mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return _scatter(g, *ctx.args), None, None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, mesh, axes):
        ctx.args = (dim, mesh, axes)
        return _scatter(x, dim, mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return _gather(g, *ctx.args), None, None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.args = (mesh, axis)
        return _a2a(x, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return _a2a(g, *ctx.args), None, None


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.args = (mesh, axes)
        return _reduce(x, mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return _reduce(g, *ctx.args), None, None


def all_gather(x: torch.Tensor, dim: int, mesh, axes) -> torch.Tensor:
    """The shards of dimension ``dim`` over ``axes`` concatenated in the
    axes' row-major order (differentiable)."""
    axes = mesh.axes(axes)
    if mesh.axes_size(axes) == 1:
        return x
    return _AllGather.apply(x, dim, mesh, axes)


def reduce_scatter(x: torch.Tensor, dim: int, mesh, axes) -> torch.Tensor:
    """The sum over ``axes`` of ``x``, cut along ``dim`` to this rank's
    shard (differentiable)."""
    axes = mesh.axes(axes)
    if mesh.axes_size(axes) == 1:
        return x
    return _ReduceScatter.apply(x, dim, mesh, axes)


def all_to_all(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """Chunk ``j`` of ``x``'s leading dimension (one chunk per rank of
    ``axis``) to rank ``j``; chunk ``j`` of the result came from rank
    ``j`` (differentiable)."""
    if mesh.shape[axis] == 1:
        return x
    if x.is_floating_point():
        return _AllToAll.apply(x, mesh, axis)
    return _a2a(x, mesh, axis)


def all_reduce(x: torch.Tensor, mesh, axes=None) -> torch.Tensor:
    """The sum of ``x`` over ``axes`` (every axis by default;
    differentiable)."""
    axes = mesh.axis_names if axes is None else mesh.axes(axes)
    if mesh.axes_size(axes) == 1:
        return x
    if x.requires_grad:
        return _AllReduce.apply(x, mesh, axes)
    return _reduce(x, mesh, axes)
