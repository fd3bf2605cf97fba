"""Train-step builders: horizontal vs vertical gradient accumulation —
the port's in-process, in-memory oracle for the offload engine.

GreedySnake's key identity (§3.4): vertical scheduling — running each
layer over ALL micro-batches before the next layer — computes exactly the
same gradients as horizontal micro-batch accumulation (linearity of the
summed gradient).

* ``horizontal``: a loop over M micro-batches; each runs the full model
  forward + backward (per-layer remat) and accumulates f32 gradients.
* ``vertical``: the concatenated global batch runs layer by layer with
  per-layer remat — parameters are used once per layer per iteration and
  gradients produced once.

Optimizer-step overlap (§4.3/4.4) is expressed through the α-delayed
partial Adam: ``alpha`` of every layer's update is deferred into the
next iteration's forward. Parameters and optimizer state live on the
device of the parameters the caller passes.

Sharded (``layout``, a ``launch.shardings.Layout``): every rank of the
bound mesh calls the step with its parameter and optimizer-state shards
and its batch slice. The model gathers each layer's parameters at use;
each rank differentiates its own loss, and the collectives' transposes
sum the gradient of every rank's loss onto each shard (reduce-scatter of
the gathers, all-to-all of the MoE dispatch). The step then sums each
leaf's gradient over the axes the leaf is replicated on and divides by
the world size: the global batch's mean gradient, whether or not ranks
share a batch slice (the ranks of one "model" group do in the baseline,
none do when the batch spans every axis). The loss is the mean of the
ranks' losses, which is the global mean: every slice holds as many
weighted tokens.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from repro_torch import resolve_device, tree
from repro_torch.launch import collectives as coll
from repro_torch.launch import shardings as sh
from repro_torch.models import model as model_lib
from repro_torch.optim import (AdamConfig, DelayedAdamState, apply_early,
                               apply_update, clip_by_global_norm, flush_late,
                               global_norm, init_delayed, init_state)


@dataclasses.dataclass(frozen=True)
class ScheduleConfig:
    schedule: str = "vertical"       # "vertical" | "horizontal"
    num_microbatches: int = 1        # M (horizontal splits the batch; for
                                     # vertical, M only documents the batch
                                     # composition — execution is layerwise)
    alpha: float = 0.0               # delayed-optimizer ratio (§4.4)
    clip_norm: Optional[float] = None
    remat: bool = True


# The gradients' spec tree, set by the launcher (the reference pins it on
# the gradients so the data-axis all-reduce becomes a reduce-scatter).
# The port's sharded step always returns each leaf's gradient as this
# rank's shard in the parameters' layout; a pinned tree must be that
# layout, and anything else raises where the reference's constraint
# would be dropped.
_GRAD_SHARDINGS = None


def set_grad_shardings(specs) -> None:
    global _GRAD_SHARDINGS
    _GRAD_SHARDINGS = specs


def _check_grad_shardings(layout) -> None:
    if _GRAD_SHARDINGS is None:
        return
    if layout is None:
        raise ValueError("gradient shardings are set and the step is not "
                         "sharded")
    for a, b in zip(tree.flatten_with_path(_GRAD_SHARDINGS),
                    tree.flatten_with_path(layout.params), strict=True):
        if a != b:
            raise ValueError(f"the gradient of {b[0]} is sharded {b[1]}, "
                             f"not {a[1]} as pinned")


def _split(batch, m: int):
    """The batch dict as m micro-batch dicts along the leading axis."""
    return [tree.tree_map(lambda x: x[i * (x.shape[0] // m):
                                      (i + 1) * (x.shape[0] // m)], batch)
            for i in range(m)]


def _value_and_grad(cfg, sched: ScheduleConfig, params, batch, layout=None):
    leaves, treedef = tree.flatten(params)
    leaves = [p.detach().requires_grad_() for p in leaves]
    with torch.enable_grad(), model_lib.sharded(layout):
        loss = model_lib.loss_fn(tree.unflatten(treedef, leaves), cfg, batch,
                                 remat=sched.remat, layout=layout)
        grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), tree.unflatten(treedef, list(grads))


def sum_over_replicas(grads, specs, mesh):
    """Each leaf's gradient summed over the axes its spec leaves it
    replicated on: with the collectives' transposes, the gradient of the
    SUM of every rank's objective."""
    def leaf(g, spec):
        rest = sh.replica_axes(spec, mesh)
        return coll.all_reduce(g, mesh, rest) if rest else g
    return tree.tree_map(leaf, grads, specs)


def _reduce_over_ranks(loss, grads, layout):
    """The global mean loss and gradient: summed over the ranks, divided
    by the world size."""
    mesh = layout.mesh
    W = mesh.size
    return (coll.all_reduce(loss, mesh) / W,
            tree.tree_map(lambda g: g / W,
                          sum_over_replicas(grads, layout.params, mesh)))


def grads_fn(cfg, sched: ScheduleConfig, layout=None) -> Callable:
    """Returns grads(params, batch) -> (loss, grads) under the schedule;
    grads have the parameters' dtypes (vertical) or f32 (horizontal).
    With a ``layout``: this rank's shards in, the global mean loss and
    this rank's shards of the global mean gradient out."""
    def done(loss, grads):
        _check_grad_shardings(layout)
        if layout is None:
            return loss, grads
        return _reduce_over_ranks(loss, grads, layout)

    if sched.schedule == "vertical" or sched.num_microbatches == 1:
        def vertical(params, batch):
            return done(*_value_and_grad(cfg, sched, params, batch, layout))
        return vertical

    m = sched.num_microbatches

    def horizontal(params, batch):
        loss_sum = None
        gacc = tree.tree_map(lambda p: torch.zeros(p.shape,
                                                   dtype=torch.float32,
                                                   device=p.device), params)
        for mb in _split(batch, m):
            loss, g = _value_and_grad(cfg, sched, params, mb, layout)
            gacc = tree.tree_map(lambda a, b: a + b.float(), gacc, g)
            loss_sum = loss if loss_sum is None else loss_sum + loss
        return done(loss_sum / m, tree.tree_map(lambda g: g / m, gacc))

    return horizontal


def make_train_step(cfg, sched: ScheduleConfig, adam: AdamConfig, *,
                    layout=None):
    """Standard (α=0) train step: ``step(params, opt_state, batch) ->
    (params, opt_state, {"loss", "grad_norm"})``, for both schedules.
    With a ``layout`` each rank passes and gets back its shards (the
    optimizer state of its parameter shards), and the metrics are
    global."""
    gfn = grads_fn(cfg, sched, layout)

    def step(params, opt_state, batch):
        return train_update(opt_state, *gfn(params, batch), sched, adam,
                            layout=layout)

    return step


def train_update(opt_state, loss, grads, sched: ScheduleConfig,
                 adam: AdamConfig, *, layout=None):
    """The rest of :func:`make_train_step`'s step after ``grads_fn``: the
    norm, the clip, the Adam update. Returns (params, opt_state,
    metrics)."""
    kw = {} if layout is None else {"mesh": layout.mesh,
                                    "specs": layout.params}
    gn = global_norm(grads, **kw)
    if sched.clip_norm is not None:
        grads, _, _ = clip_by_global_norm(grads, sched.clip_norm, **kw)
    params, opt_state = apply_update(opt_state, grads, adam)
    return params, opt_state, {"loss": loss, "grad_norm": gn}


def make_delayed_train_step(cfg, sched: ScheduleConfig, adam: AdamConfig):
    """GreedySnake train step with the α-delayed optimizer (§4.4).

    State is ``DelayedAdamState``. Per iteration: 1. flush the pending α
    fraction of the previous step's update; 2. forward + backward under
    the schedule; 3. apply the (1-α) early fraction and retain the grads
    as pending. N iterations followed by a final flush are bit-identical
    (f32) to N standard Adam steps."""
    gfn = grads_fn(cfg, sched)
    alpha = sched.alpha

    def step(state: DelayedAdamState, batch):
        params, state = flush_late(state, adam, alpha)
        loss, grads = gfn(params, batch)
        gn = global_norm(grads)
        if sched.clip_norm is not None:
            grads, _, _ = clip_by_global_norm(grads, sched.clip_norm)
        params, state = apply_early(state, grads, adam, alpha)
        return params, state, {"loss": loss, "grad_norm": gn}

    return step


def init_train_state(cfg, seed: int = 0, *, delayed: bool = False,
                     params=None, dtype=torch.bfloat16, device=None):
    """(params, AdamState) — or (params, DelayedAdamState) — on ``device``
    (``cuda`` unless the caller names another). ``params`` (the port's
    tree) replaces the seeded init."""
    if params is None:
        params = model_lib.init_params(cfg, seed, dtype=dtype,
                                       device=resolve_device(device))
    opt = init_state(params)
    if not delayed:
        return params, opt
    return params, init_delayed(opt, params)
