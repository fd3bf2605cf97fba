"""Partition specs for every parameter, optimizer, batch and cache leaf,
and the local shards and gathers they imply.

The port of the reference's ``launch/shardings.py``. Parameters are
FSDP-sharded over the "model" axis (the paper integrates ZeRO-style FSDP,
§5): each weight leaf is sharded along its largest mesh-divisible
dimension and gathered at use — the analogue of GreedySnake's parameter
loads. Stacked period leaves (the leading n_periods dimension) are never
sharded on the layer dimension, so a period's slice is gathered once per
layer per pass under the vertical schedule. The batch shards over
("pod", "data"); decode caches shard the sequence over "model".

A spec is a :class:`P`: one entry per dimension, each an axis name, a
tuple of names (the first major) or ``None``, as JAX's ``PartitionSpec``
reads; ``P()`` is replicated. Rules take a leaf's path as
``tree.flatten_with_path`` writes it, which is the reference's
``_path_str`` of the same leaf. Where the reference hands XLA a
``NamedSharding`` and lets it cut and move the data, the port cuts this
rank's shard itself (:func:`shard_params`, :func:`shard_batch`,
:func:`shard_caches`) and gathers at use (:func:`gather_tree`).
Shards are even: the rules only take divisible dimensions.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional, Tuple

import torch

from repro_torch import tree
from repro_torch.launch import collectives as coll
from repro_torch.launch.mesh import (batch_axes, batch_axis_size,
                                     model_axis_size)


class P:
    """A partition spec: one entry a dimension (an axis name, a tuple of
    names, or ``None``). Not a tuple, so that a tree of specs has the
    parameters' structure; ``tuple(spec)`` gives the entries. A tuple of
    one name is that name and an empty tuple ``None``, as in JAX."""

    __slots__ = ("dims",)

    def __init__(self, *dims):
        self.dims = tuple(
            (d[0] if len(d) == 1 else d or None) if isinstance(d, tuple)
            else d for d in dims)

    def __iter__(self):
        return iter(self.dims)

    def __len__(self):
        return len(self.dims)

    def __getitem__(self, i):
        return self.dims[i]

    def __eq__(self, other):
        return isinstance(other, P) and self.dims == other.dims

    def __hash__(self):
        return hash(self.dims)

    def __repr__(self):
        return f"P{self.dims!r}"


def _size(mesh, entry) -> int:
    return math.prod(mesh.shape[a] for a in mesh.axes(entry))


def split_axes(spec: P, mesh) -> Tuple[str, ...]:
    """The axes ``spec`` splits a leaf over, in mesh order."""
    split = {a for e in spec for a in mesh.axes(e)}
    return tuple(a for a in mesh.axis_names if a in split)


def replica_axes(spec: P, mesh) -> Tuple[str, ...]:
    """The axes a leaf of ``spec`` is replicated over, in mesh order."""
    split = split_axes(spec, mesh)
    return tuple(a for a in mesh.axis_names if a not in split)


# ---------------------------------------------------------------------------
# The rules
# ---------------------------------------------------------------------------

def param_pspec(name: str, shape, mesh, *, expert_parallel: bool = False,
                fully_shard: bool = False) -> P:
    """FSDP rule: shard the largest divisible dim on "model".

    With ``expert_parallel`` MoE expert weights (…/moe/w_*: (E, d, f))
    shard the EXPERT dim instead: expert weights stay on their shard and
    only the dispatched tokens cross the mesh (all-to-all). With
    ``fully_shard`` a second dimension spreads over the other axes, so
    params and optimizer states rest at N bytes / |ranks|."""
    shape = tuple(shape)
    msize = model_axis_size(mesh)
    if len(shape) == 0 or msize == 1:
        return P()
    start = 1 if "periods" in name else 0     # skip the stacked layer dim
    dims = list(range(start, len(shape)))
    if not dims:
        return P()
    spec: list = [None] * len(shape)
    if expert_parallel and "moe/w_" in name and len(dims) >= 3 \
            and shape[start] % msize == 0:
        spec[start] = "model"                 # the expert dim
    else:
        cand = [d for d in dims if shape[d] % msize == 0]
        if not cand:
            return P()
        d = max(cand, key=lambda i: shape[i])
        spec[d] = "model"
    if fully_shard:
        dax = tuple(a for a in mesh.axis_names if a != "model")
        dsize = math.prod(mesh.shape[a] for a in dax)
        rest = [d for d in dims if spec[d] is None and shape[d] % dsize == 0]
        if rest and dsize > 1:
            d2 = max(rest, key=lambda i: shape[i])
            spec[d2] = dax if len(dax) > 1 else dax[0]
    return P(*spec)


def param_specs(params, mesh, *, expert_parallel: bool = False,
                fully_shard: bool = False):
    """The spec tree of ``params`` (any device, ``meta`` included)."""
    leaves, treedef = tree.flatten(params)
    specs = [param_pspec(name, leaf.shape, mesh,
                         expert_parallel=expert_parallel,
                         fully_shard=fully_shard)
             for name, leaf in tree.flatten_with_path(params)]
    return tree.unflatten(treedef, specs)


def opt_state_shardings(param_specs_tree, mesh):
    """AdamState(master, m, v, step): states shard like params."""
    from repro_torch.optim import AdamState
    return AdamState(master=param_specs_tree, m=param_specs_tree,
                     v=param_specs_tree, step=replicated(mesh))


def batch_pspec(shape, mesh, *, batch_dim: int = 0,
                include_model: bool = False) -> P:
    """Shard dim0 over the batch axes; with ``include_model`` the batch
    also spreads over "model" (pure FSDP: activations fully
    batch-sharded, parameters gathered at use). Falls back to
    progressively fewer axes when the batch is not divisible."""
    bax = batch_axes(mesh)
    candidates = []
    if include_model:
        candidates.append(tuple(bax) + ("model",))
    candidates.append(tuple(bax))
    if len(bax) > 1:
        candidates.append((bax[-1],))
    spec: list = [None] * len(shape)
    for axes in candidates:
        n = math.prod(mesh.shape[a] for a in axes)
        if n > 1 and shape[batch_dim] % n == 0:
            spec[batch_dim] = axes if len(axes) > 1 else axes[0]
            break
    return P(*spec)


def cache_pspec(name: str, shape, mesh, *, stacked: bool) -> P:
    """Decode caches: batch on ("pod","data"), sequence on "model".

    Layouts: KVCache.k/v (B, Hk, S, hd) -> (bax, None, "model", None);
    KVCache.slot_pos (S,) replicated; MLACache.latent / k_rope (B, S, r)
    -> (bax, "model", None); MambaState.conv (B, K-1, di) -> (bax, None,
    "model"); MambaState.h (B, di, st) -> (bax, "model", None). Stacked
    period caches carry a leading n_periods dim (skipped)."""
    msize = model_axis_size(mesh)
    bax = batch_axes(mesh)
    bsz = batch_axis_size(mesh)
    shape = list(shape)
    off = 1 if stacked and "periods" in name else 0
    spec: list = [None] * len(shape)
    if "slot_pos" in name:
        return P(*spec)
    ndim = len(shape) - off
    if ndim == 0:
        return P(*spec)
    if bsz > 1 and shape[off] % bsz == 0:
        spec[off] = bax
    if msize > 1:
        if "latent" in name or "k_rope" in name:
            if ndim >= 2 and shape[off + 1] % msize == 0:
                spec[off + 1] = "model"
        elif name.endswith("k") or name.endswith("v"):
            if ndim >= 3 and shape[off + 2] % msize == 0:
                spec[off + 2] = "model"
        elif "conv" in name:
            if ndim >= 3 and shape[off + 2] % msize == 0:
                spec[off + 2] = "model"
        elif "/h" in name or name.endswith("h"):
            if ndim >= 2 and shape[off + 1] % msize == 0:
                spec[off + 1] = "model"
    return P(*spec)


def cache_specs(caches, mesh):
    leaves, treedef = tree.flatten(caches)
    return tree.unflatten(treedef, [
        cache_pspec(name, leaf.shape, mesh, stacked=True)
        for name, leaf in tree.flatten_with_path(caches)])


def replicated(mesh) -> P:
    return P()


# ---------------------------------------------------------------------------
# Local shards, gathers
# ---------------------------------------------------------------------------

def local_shape(shape, spec: P, mesh) -> Tuple[int, ...]:
    """The shape of one rank's shard (any mesh, bound or not)."""
    out = list(shape)
    for d, entry in enumerate(spec):
        n = _size(mesh, entry)
        if out[d] % n:
            raise ValueError(f"dimension {d} of {tuple(shape)} does not "
                             f"split over {entry} ({n} ranks)")
        out[d] //= n
    return tuple(out)


def local_shard(x: torch.Tensor, spec: P, mesh) -> torch.Tensor:
    """This rank's shard of the full tensor ``x``, in memory of its own
    (never a view that keeps ``x`` alive)."""
    out = x
    for d, entry in enumerate(spec):
        axes = mesh.axes(entry)
        n = mesh.axes_size(axes)
        if n == 1:
            continue
        if out.shape[d] % n:
            raise ValueError(f"dimension {d} of {tuple(x.shape)} does not "
                             f"split over {axes} ({n} ranks)")
        s = out.shape[d] // n
        out = out.narrow(d, mesh.axes_index(axes) * s, s)
    return out.clone(memory_format=torch.contiguous_format)


def shard_tree(full, specs, mesh):
    """This rank's shard of every leaf of ``full`` by its spec."""
    return tree.tree_map(lambda x, s: local_shard(x, s, mesh), full, specs)


def shard_params(params, mesh, *, expert_parallel: bool = False,
                 fully_shard: bool = False):
    """This rank's shard of every parameter leaf."""
    return shard_tree(params, param_specs(params, mesh,
                                    expert_parallel=expert_parallel,
                                    fully_shard=fully_shard), mesh)


def shard_batch(batch, mesh, *, include_model: bool = False):
    """This rank's slice of every batch leaf (dim 0 by ``batch_pspec``)."""
    return tree.tree_map(lambda x: local_shard(
        x, batch_pspec(x.shape, mesh, include_model=include_model), mesh),
        batch)


def shard_caches(caches, mesh):
    """This rank's shard of every decode-cache leaf."""
    return shard_tree(caches, cache_specs(caches, mesh), mesh)


def gather(x: torch.Tensor, spec: P, mesh, keep=()) -> torch.Tensor:
    """The full tensor from this rank's shard ``x``: every sharded
    dimension gathered, lowest first, except the dimensions in ``keep``
    (differentiable: the gradient is reduce-scattered back). The result
    is contiguous, as the unsharded leaf is: a product with a strided
    view of the gathered rows would round otherwise."""
    for d, entry in enumerate(spec):
        if entry is not None and d not in keep:
            x = coll.all_gather(x, d, mesh, entry).contiguous()
    return x


def gather_tree(local, specs, mesh,
                keep: Optional[Callable[[str, P], tuple]] = None):
    """:func:`gather` over a tree; ``keep(path, spec)`` names the
    dimensions of a leaf (its path within ``local``) that stay sharded."""
    paths = [p for p, _ in tree.flatten_with_path(local)]
    leaves, treedef = tree.flatten(local)
    spec_leaves = tree.leaves(specs)
    return tree.unflatten(treedef, [
        gather(x, s, mesh, keep(path, s) if keep else ())
        for path, x, s in zip(paths, leaves, spec_leaves)])


@torch.no_grad()
def unshard(x: torch.Tensor, spec: P, mesh) -> torch.Tensor:
    """The full tensor from this rank's shard (a collective call: every
    rank of the mesh calls it for the same leaf)."""
    return gather(x, spec, mesh)


def unshard_tree(local, specs, mesh):
    return tree.tree_map(lambda x, s: unshard(x, s, mesh), local, specs)


def slice_specs(specs):
    """Specs of one period's slice of stacked leaves: the leading
    n_periods dimension dropped (it is never sharded)."""
    def drop(s: P) -> P:
        if len(s) and s[0] is not None:
            raise ValueError(f"a stacked leaf is sharded on its layer "
                             f"dimension: {s}")
        return P(*s.dims[1:])
    return tree.tree_map(drop, specs)


# ---------------------------------------------------------------------------
# The sharded steps' layouts
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Layout:
    """Where a sharded train step's leaves live: the bound ``mesh``, the
    spec tree of the parameters (and so of their gradients and optimizer
    state) and the axes the batch's leading dimension is split over."""
    mesh: Any
    params: Any
    batch_axes: Tuple[str, ...]


def train_layout(params, batch, mesh, *, expert_parallel: bool = False,
                 fully_shard: bool = False,
                 include_model: bool = False) -> Layout:
    """The layout of a step over full-size ``params`` and ``batch`` (their
    shapes only: ``meta`` tensors do)."""
    bspec = batch_pspec(batch["tokens"].shape, mesh,
                        include_model=include_model)
    return Layout(mesh, param_specs(params, mesh,
                                    expert_parallel=expert_parallel,
                                    fully_shard=fully_shard),
                  mesh.axes(bspec[0]))


def serve_layout(params, batch, caches, mesh) -> Layout:
    """The layout of a sharded prefill or decode step (the reference's
    ``lower_prefill`` / ``lower_decode``): parameters over "model"
    (``param_pspec``, no EP, not fully sharded), the batch over the batch
    axes (``batch_pspec``), the caches by ``cache_pspec`` (their sequence
    or channels on "model"). Shapes only: ``meta`` tensors do. A batch
    split over fewer axes than the caches' batch dimension (2 x 16 x 16
    at a batch that 16 divides and 32 does not) is refused: a rank's cache
    rows would not be its batch rows."""
    bspec = batch_pspec(batch["tokens"].shape, mesh)
    axes = mesh.axes(bspec[0])
    for (name, leaf), spec in zip(tree.flatten_with_path(caches),
                                  tree.leaves(cache_specs(caches, mesh))):
        if "slot_pos" in name:
            continue
        off = 1 if "periods" in name else 0
        if mesh.axes(spec[off]) != axes:
            raise ValueError(f"the batch is split over {axes}, the cache "
                             f"leaf {name}'s batch over "
                             f"{mesh.axes(spec[off])}")
    return Layout(mesh, param_specs(params, mesh), axes)
