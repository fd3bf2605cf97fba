"""Jobs that run on every rank of a mesh (``launch.mesh.run_ranks``): the
expert-parallel MoE, the sharded train step and the sharded prefill and
decode, from full-size inputs that every rank builds alike (the
reference's numpy parameters, or the same seed), and the closed form of
each step's collective traffic.

``chip_smoke.py``'s ``mesh`` phase and the multi-rank tests run these; a
job returns plain tensors and numbers (unsharded where the caller asks),
so the caller can hold them against an unsharded run.
"""
from __future__ import annotations

import contextlib
import functools
import gc
import math
import time
from typing import Dict

import torch

from repro_torch import tree
from repro_torch.core.schedules import (ScheduleConfig, grads_fn,
                                        set_grad_shardings,
                                        sum_over_replicas, train_update)
from repro_torch.launch import collectives as coll
from repro_torch.launch import shardings as sh
from repro_torch.launch.mesh import batch_axes, make_host_mesh, rank_device
from repro_torch.models import blocks as blk
from repro_torch.models import model as mdl
from repro_torch.models import moe as moe_lib
from repro_torch.models import moe_ep
from repro_torch.optim import AdamConfig, init_state
from repro_torch.weights import params_from_jax, shard_params_from_jax


@contextlib.contextmanager
def capacity(cf):
    """The blocks' MoE at capacity factor ``cf`` inside (``None``: the
    default 1.25)."""
    if cf is None:
        yield
        return
    orig = moe_ep.moe_dispatch
    moe_ep.moe_dispatch = functools.partial(orig, capacity_factor=cf)
    try:
        yield
    finally:
        moe_ep.moe_dispatch = orig


def _device(job) -> torch.device:
    """The job's ``device`` (e.g. ``"cpu"`` on ranks that share a card),
    else where the rank computes."""
    return torch.device(job["device"]) if "device" in job else rank_device()


def run_jobs(rank: int, jobs) -> list:
    """``(name, job)`` pairs of this module's jobs run in order on every
    rank (one spawn, one process group, for several runs)."""
    fns = {"ep": ep_job, "step": step_job, "norm": norm_job,
           "collectives": collectives_job, "prefill": prefill_job,
           "decode": decode_job}
    out = []
    for name, job in jobs:
        if "conv_from" in job:
            # a run on the card started from the same ranks' CPU tails
            job = dict(job, conv_tails=out[job["conv_from"]]["conv_tails"])
        t0 = time.perf_counter()
        out.append(fns[name](rank, job))
        out[-1]["job_seconds"] = time.perf_counter() - t0
        gc.collect()
        if torch.cuda.is_initialized():
            torch.cuda.empty_cache()    # the card is shared with the ranks
    return out


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def moe_ep_specs(params) -> dict:
    """The expert-parallel layout of one MoE layer's params: ``w_*`` on
    the expert dim over "model", router and shared experts whole."""
    return {k: (sh.P("model", None, None) if k.startswith("w_") else
                tree.tree_map(lambda _: sh.P(), v))
            for k, v in params.items()}


def ep_job(rank: int, job: dict) -> dict:
    """``moe_apply_ep`` on a ``job["mesh"]`` (data, model) mesh, EP over
    "model", the batch over every axis, at each of ``job["capacities"]``.
    Params: ``job["params"]`` (the reference's, numpy) or ``moe_init``
    from ``job["seed"]`` in ``job["dtype"]``; x: ``job["x"]`` (numpy) or
    normal * 0.3 from ``job["x_seed"]``, shape ``job["x_shape"]``. With
    ``job["grads"]``: the gradients of sum(y^2) + aux (over the global
    batch) too; ``job["reference_positions"]``: the reference's drops. Rank 0 returns y, aux and the gradients unsharded;
    every rank its EP dispatches and dropped assignments."""
    mesh = make_host_mesh(*job["mesh"])
    dev = _device(job)
    cfg = job["cfg"]
    if "params" in job:
        params = params_from_jax(job["params"], dev)
    else:
        g = torch.Generator(device=dev)
        g.manual_seed(job["seed"])
        params = moe_lib.moe_init(g, cfg, job["dtype"], device=dev)
    if "x" in job:
        x = torch.from_numpy(job["x"]).to(dev)
    else:
        g = torch.Generator(device=dev)
        g.manual_seed(job["x_seed"])
        x = (torch.randn(job["x_shape"], generator=g, device=dev)
             * 0.3).to(job["dtype"])
    bax = mesh.axis_names
    specs = moe_ep_specs(params)
    local = sh.shard_tree(params, specs, mesh)
    del params
    xspec = sh.P(bax, None, None)
    xl = sh.local_shard(x, xspec, mesh)
    moe_ep.set_ep_mesh(mesh, axis="model", bax=bax)
    out: Dict = {"dispatches": {}, "dropped": {}, "seconds": {}}
    try:
        for cf in job["capacities"]:
            moe_ep.reset_ep_dispatches()
            moe_ep.reset_dropped()
            leaves, treedef = tree.flatten(local)
            leaves = [p.detach().requires_grad_(bool(job.get("grads")))
                      for p in leaves]
            _sync(dev)
            t0 = time.perf_counter()
            with torch.set_grad_enabled(bool(job.get("grads"))):
                y, aux = moe_ep.moe_apply_ep(
                    tree.unflatten(treedef, leaves), xl, cfg,
                    capacity_factor=cf, reference_positions=bool(
                        job.get("reference_positions")))
            _sync(dev)
            out["seconds"][cf] = time.perf_counter() - t0
            out["dispatches"][cf] = moe_ep.ep_dispatches()
            out["dropped"][cf] = int(coll.all_reduce(
                torch.tensor(moe_ep.dropped_count(), dtype=torch.float64,
                             device=dev), mesh))
            res = {"y": sh.unshard(y.detach(), xspec, mesh).cpu(),
                   "aux": float(aux.detach())}
            if job.get("grads"):
                obj = (y.float() ** 2).sum() + aux / mesh.size
                gl = torch.autograd.grad(obj, leaves)
                grads = sum_over_replicas(tree.unflatten(treedef, list(gl)),
                                           specs, mesh)
                res["grads"] = tree.tree_map(
                    lambda a: a.cpu(), sh.unshard_tree(grads, specs, mesh))
            if rank == 0:
                out[cf] = res
    finally:
        moe_ep.set_ep_mesh(None)
    return out


def collectives_job(rank: int, job: dict) -> dict:
    """Each collective of ``launch.collectives`` on a ``job["mesh"]``
    mesh, forward and backward, on tensors whose values name their rank
    and element: rank ``r`` holds ``x = r * 100 + arange(12).view(4, 3)``
    (f32). Returns the results, the gradients of ``(out * w).sum()`` for
    ``w = arange(out.numel())``, and the counts."""
    mesh = make_host_mesh(*job["mesh"])
    dev = _device(job)
    coll.reset_counts()
    out = {}
    for name, axes in (("gather_data", ("data",)),
                       ("gather_all", ("data", "model"))):
        for dim in (0, 1):
            x = (rank * 100 + torch.arange(12.0, device=dev).view(4, 3)
                 ).requires_grad_()
            y = coll.all_gather(x, dim, mesh, axes)
            w = torch.arange(float(y.numel()), device=dev).view(y.shape)
            (g,) = torch.autograd.grad((y * w).sum(), x)
            out[f"{name}_{dim}"] = (y.detach().cpu(), g.cpu())
    x = (rank * 100 + torch.arange(12.0, device=dev).view(4, 3)
         ).requires_grad_()
    y = coll.reduce_scatter(x, 0, mesh, ("model",))
    (g,) = torch.autograd.grad((y * torch.arange(
        float(y.numel()), device=dev).view(y.shape)).sum(), x)
    out["scatter_model"] = (y.detach().cpu(), g.cpu())
    y = coll.all_to_all(x, mesh, "model")
    (g,) = torch.autograd.grad((y * torch.arange(
        12.0, device=dev).view(4, 3)).sum(), x)
    out["a2a_model"] = (y.detach().cpu(), g.cpu())
    y = coll.all_reduce(x, mesh)
    (g,) = torch.autograd.grad((y * torch.arange(
        12.0, device=dev).view(4, 3)).sum(), x)
    out["reduce_all"] = (y.detach().cpu(), g.cpu())
    out["counts"] = coll.counts()
    return out


def norm_job(rank: int, job: dict) -> dict:
    """``global_norm`` and ``clip_by_global_norm(job["max_norm"])`` of a
    gradient tree sharded by ``step_layout(job["mode"])``: the full tree
    is normal noise from ``job["seed"]`` shaped as ``job["cfg"]``'s
    params. Rank 0 returns the full tree, the norm and the clipped tree
    unsharded."""
    from repro_torch.optim import clip_by_global_norm, global_norm
    cfg, dev = job["cfg"], _device(job)
    mesh = make_host_mesh(*job["mesh"])
    shapes = mdl.init_params(cfg, 0, dtype=torch.float32, device="meta")
    g = torch.Generator(device=dev)
    g.manual_seed(job["seed"])
    full = tree.tree_map(lambda a: torch.randn(
        a.shape, generator=g, device=dev), shapes)
    lay = step_layout(cfg, shapes, {"tokens": torch.empty(
        job["batch"], 1, device="meta")}, mesh, job["mode"])
    specs = lay["layout"].params
    local = sh.shard_tree(full, specs, mesh)
    n = global_norm(local, mesh=mesh, specs=specs)
    clipped, coef, n2 = clip_by_global_norm(local, job["max_norm"],
                                            mesh=mesh, specs=specs)
    out = sh.unshard_tree(clipped, specs, mesh)
    if rank:
        return {}
    return {"full": full, "norm": float(n), "norm_clip": float(n2),
            "coef": float(coef), "clipped": out}


def decode_job(rank: int, job: dict) -> dict:
    """A sharded prefill of ``job["batch"]`` (numpy: ``tokens`` (B, S),
    an encoder-decoder's ``enc_embeds``, a VLM's ``image_embeds``) into
    caches of ``job["cache_len"]`` slots in ``job["dtype"]``, then one
    decode step for each of ``job["decode_tokens"]`` (numpy (steps, B,
    1), fixed inputs so that a sharded and an unsharded run see the
    same), on a ``job["mesh"]`` (data, model) mesh in the serve layout
    (``shardings.serve_layout``). Params: ``job["params"]`` (the
    reference's, numpy) or ``init_params`` from ``job["seed"]`` in
    ``job["dtype"]``. Every rank returns its logits rows of each call,
    its collective counts and their closed form
    (:func:`serve_collectives`), seconds, K1 / K3 launches and peak
    device memory; with ``job["caches"]`` its cache shards after the
    prefill (``caches_prefill``) and after the last call; with
    ``job["record_conv"]`` / ``job["conv_from"]`` the Mamba conv tails of
    each decode step recorded / taken from an earlier job of the spawn
    (:func:`_conv_tails`); with ``job["capacity"]`` the MoE at that
    capacity factor; rank 0 also
    the logits of every row (``logits_full``) and, with
    ``job["unshard"]``, the caches unsharded."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import selective_scan as k3
    cfg = job["cfg"]
    mesh = make_host_mesh(*job["mesh"])
    dev = _device(job)
    if "params" in job:
        params = params_from_jax(job["params"], dev)
    else:
        params = mdl.init_params(cfg, job["seed"], dtype=job["dtype"],
                                 device=dev)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in job["batch"].items()}
    B, S = batch["tokens"].shape
    shapes = mdl.init_caches(cfg, B, job["cache_len"], dtype=job["dtype"],
                             device="meta")
    layout = sh.serve_layout(params, batch, shapes, mesh)
    cspecs = sh.cache_specs(shapes, mesh)
    local = sh.shard_tree(params, layout.params, mesh)
    del params
    caches = sh.shard_caches(mdl.init_caches(
        cfg, B, job["cache_len"], dtype=job["dtype"], device=dev), mesh)
    bspec = sh.P(layout.batch_axes or None)
    lbatch = {k: sh.local_shard(v, bspec, mesh) for k, v in batch.items()}
    pos = S + (cfg.frontend_tokens if cfg.family == "vlm" else 0)
    out = {"rank": rank, "batch_axes": layout.batch_axes, "logits": [],
           "counts": [], "expected_counts": [], "seconds": []}
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    launches0 = (fa.fwd_launches, k3.launches)
    calls = [None] + list(job.get("decode_tokens", ()))
    if job.get("record_conv"):
        out["conv_tails"] = []
    for i, tok in enumerate(calls):
        if tok is None:
            out["expected_counts"].append(serve_collectives(
                cfg, layout, local, caches, tuple(lbatch["tokens"].shape),
                "prefill"))
        else:
            _conv_tails(caches, job, out, i - 1)
            tl = sh.local_shard(torch.from_numpy(tok).to(dev), bspec, mesh)
            out["expected_counts"].append(serve_collectives(
                cfg, layout, local, caches, tuple(tl.shape), "decode"))
        coll.reset_counts()
        _sync(dev)
        t0 = time.perf_counter()
        with capacity(job.get("capacity")):
            if tok is None:
                logits, caches = mdl.prefill(local, cfg, lbatch, caches,
                                             layout=layout)
            else:
                logits, caches = mdl.decode_step(local, cfg, tl, pos, caches,
                                                 layout=layout)
                pos += 1
        _sync(dev)
        out["seconds"].append(time.perf_counter() - t0)
        out["counts"].append(coll.counts())
        out["logits"].append(logits.cpu())
        if tok is None and job.get("caches"):
            out["caches_prefill"] = tree.tree_map(
                lambda a: a.to("cpu", copy=True), caches)
    out["k1_launches"] = fa.fwd_launches - launches0[0]
    out["k3_launches"] = k3.launches - launches0[1]
    if dev.type == "cuda":
        out["max_memory_allocated"] = torch.cuda.max_memory_allocated(dev)
    if job.get("caches"):
        out["caches"] = tree.tree_map(lambda a: a.cpu(), caches)
    full = [sh.unshard(a.to(dev), sh.P(layout.batch_axes or None, None),
                       mesh) for a in out["logits"]]
    if rank == 0:
        out["logits_full"] = [a.cpu() for a in full]
    if job.get("unshard"):
        fc = sh.unshard_tree(caches, cspecs, mesh)
        if rank == 0:
            out["caches_full"] = tree.tree_map(lambda a: a.cpu(), fc)
    return out


def _conv_tails(caches, job, out, step: int) -> None:
    """Before decode step ``step``: record this rank's Mamba conv tails
    (``job["record_conv"]``), or copy in the tails another run recorded
    (``job["conv_tails"]``, from ``"conv_from"``: the card's run started
    from its CPU twin's tails, as the single-card Mamba gates do — a tail
    value is bf16 and can round the other way on the card)."""
    conv = [(p, t) for p, t in tree.flatten_with_path(caches)
            if p.endswith(".conv")]
    if job.get("record_conv"):
        out["conv_tails"].append({p: t.to("cpu", copy=True) for p, t in conv})
    if "conv_tails" in job:
        src = job["conv_tails"][step]
        with torch.no_grad():
            for p, t in conv:
                t.copy_(src[p])


def prefill_job(rank: int, job: dict) -> dict:
    """:func:`decode_job`'s prefill alone."""
    return decode_job(rank, dict(job, decode_tokens=()))


def _has_moe(cfg) -> bool:
    return any(cfg.is_moe_layer(i) for i in range(cfg.num_layers))


def step_layout(cfg, params, batch, mesh, mode: str) -> dict:
    """The reference's two lowerings of a train step (``launch/dryrun.py``
    ``lower_train``): ``baseline`` (parameters over "model", the batch over
    the data axes) or ``optimized`` (``fully_shard``, the batch over every
    axis when it divides, expert parallelism for MoE stacks). Returns the
    layout and whether EP runs."""
    if mode not in ("baseline", "optimized"):
        raise ValueError(f"step mode {mode!r} is not baseline or optimized")
    opt = mode == "optimized"
    full_axes = tuple(batch_axes(mesh)) + ("model",)
    divides = batch["tokens"].shape[0] % mesh.axes_size(full_axes) == 0
    use_ep = opt and _has_moe(cfg) and divides
    layout = sh.train_layout(params, batch, mesh, expert_parallel=use_ep,
                             fully_shard=opt, include_model=opt and divides)
    return {"layout": layout, "use_ep": use_ep,
            "act_spec": sh.P(full_axes, None, None) if opt and divides
            else None}


@contextlib.contextmanager
def step_hooks(mesh, lay: dict, opt: bool):
    """The launcher's hooks of the optimized mode for the block: the
    activation spec, the gradient shardings and the EP mesh."""
    if opt:
        mdl.set_activation_spec(lay["act_spec"])
        set_grad_shardings(lay["layout"].params)
        if lay["use_ep"]:
            moe_ep.set_ep_mesh(mesh, axis="model",
                               bax=lay["layout"].batch_axes)
    try:
        yield
    finally:
        mdl.set_activation_spec(None)
        set_grad_shardings(None)
        moe_ep.set_ep_mesh(None)


def step_job(rank: int, job: dict) -> dict:
    """``job["steps"]`` sharded train steps of ``job["cfg"]`` (vertical,
    remat) on a ``job["mesh"]`` (data, model) mesh in ``job["mode"]``
    (:func:`step_layout`). Params: ``job["params"]`` (the reference's,
    numpy) or ``init_params`` from ``job["seed"]`` in ``job["dtype"]``;
    the global batch ``job["tokens"]`` (numpy). Optional:
    ``job["capacity"]`` (the MoE's capacity factor), ``job["lr"]``,
    ``job["grads"]`` (rank 0 also returns the first step's gradients,
    unsharded), ``job["final"]`` (rank 0 returns the updated masters,
    unsharded), ``job["reference"]`` (a file of the unsharded run's
    update, its f32 masters less the initial params: every rank returns,
    leaf by leaf, the squared norm of its shard's update less the same
    cut of the reference's, and that cut's squared norm). Every rank
    returns its per-step loss, grad norm, seconds, collective counts and
    the closed form of its counts, its EP dispatches and dropped
    assignments, K1 launches and peak device memory."""
    from repro_torch.kernels import flash_attention as fa
    cfg = job["cfg"]
    mesh = make_host_mesh(*job["mesh"])
    dev = _device(job)
    opt = job["mode"] == "optimized"
    batch = {"tokens": torch.from_numpy(job["tokens"]).to(dev)}
    lay = step_layout(cfg, mdl.init_params(cfg, 0, dtype=job["dtype"],
                                           device="meta"),
                      batch, mesh, job["mode"])
    layout = lay["layout"]
    if "params" in job:
        params = shard_params_from_jax(
            job["params"], mesh, expert_parallel=lay["use_ep"],
            fully_shard=opt, device=dev)
    else:
        params = sh.shard_tree(mdl.init_params(
            cfg, job["seed"], dtype=job["dtype"], device=dev),
            layout.params, mesh)
    lbatch = {"tokens": sh.local_shard(
        batch["tokens"], sh.P(layout.batch_axes or None), mesh)}
    sched = ScheduleConfig("vertical")
    out = {"rank": rank, "mode": job["mode"], "use_ep": lay["use_ep"],
           "batch_axes": layout.batch_axes, "losses": [], "grad_norms": [],
           "seconds": [], "counts": [], "expected_counts": []}
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    fa0 = (fa.fwd_launches, fa.bwd_launches)
    moe_ep.reset_ep_dispatches()
    moe_ep.reset_dropped()
    init = (tree.tree_map(lambda a: a.detach().to("cpu", copy=True), params)
            if job.get("reference") else None)
    adam = AdamConfig(lr=job.get("lr", AdamConfig.lr))
    with step_hooks(mesh, lay, opt), capacity(job.get("capacity")):
        opt_state = init_state(params)
        gfn = grads_fn(cfg, sched, layout)
        for i in range(job["steps"]):
            out["expected_counts"].append(step_collectives(
                cfg, layout, tuple(lbatch["tokens"].shape), lay["use_ep"],
                params, capacity_factor=job.get("capacity")))
            coll.reset_counts()
            _sync(dev)
            t0 = time.perf_counter()
            # make_train_step's step, with the gradients kept
            loss, grads = gfn(params, lbatch)
            params, opt_state, met = train_update(
                opt_state, loss, grads, sched, adam, layout=layout)
            _sync(dev)
            out["seconds"].append(time.perf_counter() - t0)
            out["losses"].append(float(met["loss"]))
            out["grad_norms"].append(float(met["grad_norm"]))
            out["counts"].append(coll.counts())
            if i == 0 and job.get("grads"):
                full_g = sh.unshard_tree(grads, layout.params, mesh)
                if rank == 0:
                    out["grads"] = tree.tree_map(lambda a: a.cpu(), full_g)
                del full_g
            del grads
    out["ep_dispatches"] = moe_ep.ep_dispatches()
    out["ep_dropped"] = moe_ep.dropped_count()
    out["k1_launches"] = (fa.fwd_launches - fa0[0], fa.bwd_launches - fa0[1])
    if dev.type == "cuda":
        out["max_memory_allocated"] = torch.cuda.max_memory_allocated(dev)
    if job.get("final"):
        fm = sh.unshard_tree(opt_state.master, layout.params, mesh)
        if rank == 0:
            out["masters"] = tree.tree_map(lambda a: a.cpu(), fm)
    if job.get("reference"):
        ref = torch.load(job["reference"], mmap=True, weights_only=True)
        out["update_leaves"], out["update_sq"] = [], []
        for (name, mine), p0, r, spec in zip(
                tree.flatten_with_path(opt_state.master), tree.leaves(init),
                tree.leaves(ref), tree.leaves(layout.params), strict=True):
            cut = sh.local_shard(r, spec, mesh).to(dev)
            diff = mine - p0.to(dev).float() - cut
            out["update_leaves"].append(name)
            out["update_sq"].append((float(diff.square().sum()),
                                     float(cut.square().sum())))
            del cut, diff
    return out


# ---------------------------------------------------------------------------
# The closed form of a step's collectives
# ---------------------------------------------------------------------------

def _zero() -> Dict[str, Dict[str, int]]:
    return {k: {"count": 0, "result_bytes": 0, "operand_bytes": 0}
            for k in coll.KINDS}


def _add(c, kind, operand: int, result: int, n: int = 1) -> None:
    c[kind]["count"] += n
    c[kind]["operand_bytes"] += n * operand
    c[kind]["result_bytes"] += n * result


def _gather_unit(c, mesh, local_shape, spec, itemsize, keep, uses: int,
                 grad: bool = True):
    """``uses`` gathers of one leaf and (``grad``) the one reduce-scatter
    of its gradient."""
    steps = []
    nbytes = math.prod(local_shape) * itemsize
    for d, entry in enumerate(spec):
        if entry is None or d in keep:
            continue
        n = mesh.axes_size(mesh.axes(entry))
        if n > 1:
            steps.append((nbytes, nbytes * n))
            nbytes *= n
    for op, res in steps:
        _add(c, "all-gather", op, res, uses)
    for op, res in reversed(steps if grad else ()):
        _add(c, "reduce-scatter", res, op)


def _param_gathers(c, cfg, shapes, specs, mesh, *, uses: int, grad: bool,
                   encoder: bool) -> None:
    """The gathers at use of every parameter leaf (``shapes``: full-size
    leaves in the shards' dtypes): each block and period slice ``uses``
    times, the embedding, head and final norm once (the embedding again as
    a tied head), an encoder-decoder's encoder stack when ``encoder``;
    with ``grad`` one reduce-scatter of each gathered gradient."""
    def unit(local_tree, spec_tree, n):
        for (p, leaf), spec in zip(tree.flatten_with_path(local_tree),
                                   tree.leaves(spec_tree)):
            # the leaf's dimensions the model's gather leaves sharded
            _gather_unit(c, mesh, sh.local_shape(leaf.shape, spec, mesh),
                         spec, leaf.element_size(),
                         moe_ep.stationary_dims(p, spec), n, grad)

    def stack(sp, spec_sp, plan):
        for part in ("prefix", "suffix"):
            for j in range(len(getattr(plan, part))):
                unit(sp[part][j], spec_sp[part][j], uses)
        if plan.n_periods:
            one = mdl._period_slice(sp["periods"], 0)
            for _ in range(plan.n_periods):
                unit(one, sh.slice_specs(spec_sp["periods"]), uses)

    tops = ["embed", "final_norm"] + (["embed"] if cfg.tie_embeddings
                                      else ["unembed"])
    for k in tops:
        unit(shapes[k], specs[k], 1)
    stack(shapes, specs, blk.build_plan(cfg))
    if cfg.family == "encdec" and encoder:
        stack(shapes["encoder"], specs["encoder"], mdl._encoder_plan(cfg))
        unit(shapes["encoder"]["final_norm"],
             specs["encoder"]["final_norm"], 1)


def _full_shapes(cfg, params):
    """The full-size parameter tree on ``meta``, in the shards' dtypes."""
    return tree.tree_map(
        lambda m, p: m.to(p.dtype),
        mdl.init_params(cfg, 0, dtype=params["embed"].dtype, device="meta"),
        params)


def step_collectives(cfg, layout, local_tokens_shape, use_ep: bool,
                     params, *, capacity_factor=None, remat: bool = True):
    """What one vertical train step (``make_train_step`` with ``layout``,
    no clipping) moves on each rank, by kind, from the spec tree and the
    model's plan: every checkpointed block and period slice gathered at
    use and again in its recompute (``remat``), the embedding, head and
    final norm once (the embedding again as a tied head), one
    reduce-scatter of each gathered gradient; per MoE layer either EP's
    two all-reduces (``me``, ``ce``) and three all-to-alls per pass plus
    the backward's two all-to-alls and one all-reduce, or the gather of
    its tokens over the batch axes and its transpose; then the loss's
    all-reduce, one all-reduce per gradient leaf replicated on some axis
    and one per set of axes the norm sums over. ``params`` (this rank's
    shards) give the leaves' dtypes. Call it under the step's EP mesh
    (:func:`step_hooks`): the expert weights EP leaves sharded are
    ``moe_ep.stationary_dims``'s, as in the model's gathers."""
    mesh = layout.mesh
    cf = 1.25 if capacity_factor is None else capacity_factor
    U = 2 if remat else 1
    c = _zero()
    shapes = _full_shapes(cfg, params)
    specs = layout.params
    _param_gathers(c, cfg, shapes, specs, mesh, uses=U, grad=True,
                   encoder=True)

    # MoE layers
    n_moe = sum(1 for i in range(cfg.num_layers) if cfg.is_moe_layer(i))
    B, St = local_tokens_shape
    S = St + (cfg.frontend_tokens if cfg.family == "vlm" else 0)
    isz = params["embed"].element_size()       # the activations' dtype
    d, E, K = cfg.d_model, cfg.num_experts, cfg.moe_top_k
    if n_moe and use_ep:
        m = mesh.shape["model"]
        C1 = max(1, int(math.ceil(B * S * K / m * cf)))
        xb = m * C1 * d * isz
        _add(c, "all-reduce", E * 4, E * 4, n_moe * (2 * U + 1))
        _add(c, "all-to-all", xb, xb, n_moe * (2 * U + 2))
        _add(c, "all-to-all", m * C1 * 4, m * C1 * 4, n_moe * U)
    elif n_moe:
        n = mesh.axes_size(layout.batch_axes)
        if n > 1:
            xb = B * S * d * isz
            _add(c, "all-gather", xb, xb * n, n_moe * U)
            _add(c, "reduce-scatter", xb * n, xb, n_moe)
    # the loss, the replicated gradients, the norm
    _add(c, "all-reduce", 4, 4)
    norm_axes = []
    for leaf, spec in zip(tree.leaves(shapes), tree.leaves(specs)):
        rest = sh.replica_axes(spec, mesh)
        if rest and mesh.axes_size(rest) > 1:
            nb = math.prod(sh.local_shape(leaf.shape, spec, mesh)) \
                * leaf.element_size()
            _add(c, "all-reduce", nb, nb)
        axes = sh.split_axes(spec, mesh)
        if axes and axes not in norm_axes:
            norm_axes.append(axes)
    for axes in norm_axes:
        if mesh.axes_size(axes) > 1:
            _add(c, "all-reduce", 4, 4)
    return c


def serve_collectives(cfg, layout, params, caches, batch_shape,
                      mode: str):
    """What one sharded ``prefill`` or ``decode_step`` (``mode``) moves on
    each rank, by kind: every block and period slice gathered at use once
    (no gradients, so no reduce-scatter), the embedding, head and final
    norm once (the embedding again as a tied head), an encoder-decoder's
    encoder in prefill; each MoE layer's gather of its tokens over the
    batch axes; in decode, one all-gather over "model" of the partial
    softmax (max, sum, f32 accumulator) of each attention layer whose
    cache is split along the sequence, of K1's (out, lse) of each
    cross-attention over split frames, and of each split Mamba state's
    conv tail and h. ``params`` and ``caches`` are this rank's shards
    (their dtypes and split dimensions count); ``batch_shape`` the rank's
    ``(B, S)`` tokens."""
    mesh = layout.mesh
    c = _zero()
    _param_gathers(c, cfg, _full_shapes(cfg, params), layout.params, mesh,
                   uses=1, grad=False, encoder=mode == "prefill")
    B, S = batch_shape
    if mode == "prefill" and cfg.family == "vlm":
        S += cfg.frontend_tokens
    n_moe = sum(1 for i in range(cfg.num_layers) if cfg.is_moe_layer(i))
    n = mesh.axes_size(layout.batch_axes)
    if n_moe and n > 1:
        xb = B * S * cfg.d_model * params["embed"].element_size()
        _add(c, "all-gather", xb, xb * n, n_moe)
    if mode != "decode":
        return c
    m = mesh.shape["model"]

    def parts(nbytes):
        _add(c, "all-gather", nbytes, nbytes * m)

    for u in mdl.cache_units(cfg):
        unit = mdl.get_cache_unit(caches, u)
        kv = unit.get("kv")
        if kv is not None and hasattr(kv, "latent"):
            if kv.latent.shape[1] != kv.slot_pos.shape[0]:
                parts(kv.latent.shape[0] * cfg.num_heads
                      * (kv.latent.shape[2] + 2) * 4)
        elif kv is not None and kv.k.shape[2] != kv.slot_pos.shape[0]:
            parts(kv.k.shape[0] * cfg.num_heads * (kv.v.shape[3] + 2) * 4)
        ckv = unit.get("cross_kv")
        if ckv is not None and ckv.k.shape[2] != ckv.slot_pos.shape[0]:
            parts(ckv.k.shape[0] * cfg.num_heads * (ckv.v.shape[3] + 1) * 4)
        st = unit.get("ssm")
        if st is not None and st.h.shape[1] != cfg.d_inner:
            for t in st:
                parts(t.numel() * t.element_size())
    return c


def counts_equal(a, b) -> bool:
    return all(a[k][f] == b[k][f] for k in coll.KINDS
               for f in ("count", "result_bytes", "operand_bytes"))


