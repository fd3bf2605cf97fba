"""Multi-pod dry-run: trace every (arch x shape x mesh) as rank 0 of a
256- or 512-rank job and record its cost — the port's counterpart of the
reference's ``launch/dryrun.py``.

The reference lowers and compiles each step for a forced device count
and reads XLA's memory and cost analyses. The port runs rank 0's program
itself: the process joins a *fake* process group of the mesh's size
(``torch.distributed``'s ``fake`` backend with a ``FakeStore``: every
collective returns at once with tensors of the right shapes), binds the
production mesh to it, and runs the step on ``meta`` tensors — this
rank's parameter, optimizer, batch and cache shards by the spec rules —
inside ``launch.cost.CostCounter``. Nothing is allocated on any device;
the hand-written kernels take their shape-only paths
(``kernels._shape_only``). A process group is global to its process, so
the dry-run runs in a process of its own: the CLI, or :func:`spawn` from
a test or ``chip_smoke.py``.

``trace_train`` (both of the reference's lowerings: ``baseline``, and
``--fsdp``: fully sharded, the batch over every axis where it divides,
expert parallelism for MoE stacks), ``trace_prefill`` and
``trace_decode`` take the place of ``lower_*``. A record carries the
reference's keys where they have a meaning (``flops_per_device``,
``bytes_accessed_per_device``, ``memory.argument_bytes`` /
``output_bytes`` / ``peak_estimate_bytes``, ``collectives``,
``total_params``, ``active_params``) and ``trace_s`` in place of
``lower_s`` / ``compile_s``; its collective counts are held to their
closed form (``sharded.step_collectives`` / ``serve_collectives``) and a
combination whose counts differ fails. ``argument_bytes`` is the shard
bytes of the step's tensors (the optimizer step counter and the decode
position are host integers in the port); with ``--host-offload`` the
optimizer state counts as host bytes (``host_argument_bytes``), not
device bytes. ``peak_estimate_bytes`` is ``MemTracker``'s peak of live
``meta`` storages, arguments included: op by op, unfused, eager — not
XLA's fused estimate.

Run: ``python -m repro_torch.launch.dryrun --arch qwen3-4b --shape
train_4k --mesh single`` (``--arch all --shape all --mesh both`` for the
matrix). Records go to ``experiments/dryrun_torch/``, never to the
reference's ``experiments/dryrun/``.
"""
from __future__ import annotations

import argparse
import functools
import json
import math
import os
import sys
import time
from typing import Dict, List, Tuple

import torch

from repro_torch import tree
from repro_torch.configs import (ASSIGNED_ARCHS, INPUT_SHAPES, get_config,
                                 supports_shape)
from repro_torch.core.schedules import ScheduleConfig, grads_fn, train_update
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import sharded
from repro_torch.launch import shardings as sh
from repro_torch.launch.cost import CostCounter
from repro_torch.models import model as mdl
from repro_torch.optim import AdamConfig, init_state

OUT_DIR = os.path.join("experiments", "dryrun_torch")
_REFERENCE_OUT = os.path.join("experiments", "dryrun")


# ---------------------------------------------------------------------------
# The fake world
# ---------------------------------------------------------------------------

def join_fake_world(size: int, rank: int = 0) -> None:
    """Make this process ``rank`` of a fake ``size``-rank process group
    (leaving any group it was in; every mesh bound to it is dropped)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_world_size() == size and dist.get_rank() == rank:
            return
        mesh_lib._bound.clear()
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=size)


def production_mesh(multi_pod: bool):
    """The production mesh bound to a fake world of its size."""
    join_fake_world(512 if multi_pod else 256)
    return mesh_lib.make_production_mesh(multi_pod=multi_pod)


# ---------------------------------------------------------------------------
# Input specs (meta tensors; no device allocation)
# ---------------------------------------------------------------------------

def batch_specs(cfg, batch: int, seq: int) -> Dict[str, torch.Tensor]:
    """Training / prefill batch for one architecture family."""
    def meta(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")
    if cfg.family == "vlm":
        return {"tokens": meta((batch, seq - cfg.frontend_tokens),
                               torch.int32),
                "image_embeds": meta((batch, cfg.frontend_tokens,
                                      cfg.d_model), torch.bfloat16)}
    out = {"tokens": meta((batch, seq), torch.int32)}
    if cfg.family == "encdec":
        out["enc_embeds"] = meta((batch, cfg.encoder_seq, cfg.d_model),
                                 torch.bfloat16)
    return out


def input_specs(arch: str, shape_name: str):
    cfg = get_config(arch)
    shp = INPUT_SHAPES[shape_name]
    return batch_specs(cfg, shp.global_batch, shp.seq_len)


def _nbytes(*trees) -> int:
    return sum(t.numel() * t.element_size() for x in trees
               for t in tree.leaves(x) if isinstance(t, torch.Tensor))


@functools.lru_cache(maxsize=None)
def meta_params(cfg):
    """The full-size parameter tree on ``meta`` (bf16), built once a
    config: a full-size init walks every layer."""
    return mdl.init_params(cfg, 0, dtype=torch.bfloat16, device="meta")


@functools.lru_cache(maxsize=None)
def meta_caches(cfg, batch: int, seq_len: int):
    """The full-size decode caches on ``meta`` (bf16), built once."""
    return mdl.init_caches(cfg, batch, seq_len, device="meta")


def _shard_bytes(leaves, specs, mesh, itemsize=None) -> int:
    return sum(math.prod(sh.local_shape(t.shape, s, mesh))
               * (itemsize or t.element_size())
               for t, s in zip(tree.leaves(leaves), tree.leaves(specs),
                               strict=True))


def argument_bytes(cfg, mesh, shape, *, fsdp_batch: bool = False,
                   host_offload: bool = False) -> Tuple[int, int]:
    """(device, host) bytes of one rank's step arguments by the spec
    rules alone, no trace (any mesh, bound or not): the parameter shards
    (bf16), in train the optimizer's f32 master, m and v shards (host
    bytes with ``host_offload``) and the batch rows, in serving the batch
    rows (a decode's tokens) and the cache shards."""
    params = meta_params(cfg)
    batch = batch_specs(cfg, shape.global_batch, shape.seq_len)
    if shape.kind == "train":
        layout = sharded.step_layout(
            cfg, params, batch, mesh,
            "optimized" if fsdp_batch else "baseline")["layout"]
        opt = 3 * _shard_bytes(params, layout.params, mesh, itemsize=4)
        extra, host = (0, opt) if host_offload else (opt, 0)
    else:
        caches = meta_caches(cfg, shape.global_batch, shape.seq_len)
        layout = sh.serve_layout(params, batch, caches, mesh)
        if shape.kind == "decode":
            batch = {"tokens": torch.empty((shape.global_batch, 1),
                                           dtype=torch.int32, device="meta")}
        extra = _shard_bytes(caches, sh.cache_specs(caches, mesh), mesh)
        host = 0
    bspec = sh.P(layout.batch_axes or None)
    b = sum(math.prod(sh.local_shape(t.shape, bspec, mesh))
            * t.element_size() for t in batch.values())
    return _shard_bytes(params, layout.params, mesh) + b + extra, host


def _local_batch(batch, layout):
    spec = sh.P(layout.batch_axes or None)
    return {k: sh.local_shard(v, spec, layout.mesh) for k, v in batch.items()}


# ---------------------------------------------------------------------------
# Tracers: rank 0's step on meta tensors
# ---------------------------------------------------------------------------

def trace_train(cfg, mesh, shape, *, schedule: str = "vertical",
                microbatches: int = 8, remat: bool = True,
                fsdp_batch: bool = False, host_offload: bool = False,
                track_peak: bool = True) -> dict:
    """One train step (the reference's ``lower_train``) of this rank on
    the bound ``mesh``: returns the cost, the memory, the collectives
    and their closed form."""
    params = meta_params(cfg)
    batch = batch_specs(cfg, shape.global_batch, shape.seq_len)
    mode = "optimized" if fsdp_batch else "baseline"
    lay = sharded.step_layout(cfg, params, batch, mesh, mode)
    layout = lay["layout"]
    local = sh.shard_tree(params, layout.params, mesh)
    lbatch = _local_batch(batch, layout)
    opt = init_state(local)
    sched = ScheduleConfig(schedule=schedule, num_microbatches=microbatches,
                           remat=remat)
    opt_bytes = _nbytes(opt.master, opt.m, opt.v)
    with sharded.step_hooks(mesh, lay, fsdp_batch):
        expected = sharded.step_collectives(
            cfg, layout, tuple(lbatch["tokens"].shape), lay["use_ep"], local,
            remat=remat)
        with CostCounter(external=tree.leaves((local, opt.master, opt.m,
                                               opt.v, lbatch)),
                         track_peak=track_peak) as cc:
            loss, grads = grads_fn(cfg, sched, layout)(local, lbatch)
            new, new_opt, met = train_update(opt, loss, grads, sched,
                                             AdamConfig(), layout=layout)
    args = _nbytes(local, lbatch) + (0 if host_offload else opt_bytes)
    out = _nbytes(new, met["loss"], met["grad_norm"]) + (
        0 if host_offload else _nbytes(new_opt.master, new_opt.m,
                                       new_opt.v))
    return {"cost": cc.result(), "argument_bytes": args,
            "output_bytes": out,
            "host_argument_bytes": opt_bytes if host_offload else 0,
            "expected_collectives": expected, "use_ep": lay["use_ep"],
            "batch_axes": layout.batch_axes}


def _serve_inputs(cfg, mesh, shape):
    params = meta_params(cfg)
    caches = meta_caches(cfg, shape.global_batch, shape.seq_len)
    batch = batch_specs(cfg, shape.global_batch, shape.seq_len)
    layout = sh.serve_layout(params, batch, caches, mesh)
    return (sh.shard_tree(params, layout.params, mesh),
            sh.shard_caches(caches, mesh), batch, layout)


def trace_prefill(cfg, mesh, shape, *, track_peak: bool = True) -> dict:
    """One prefill (the reference's ``lower_prefill``) of this rank."""
    local, caches, batch, layout = _serve_inputs(cfg, mesh, shape)
    lbatch = _local_batch(batch, layout)
    expected = sharded.serve_collectives(
        cfg, layout, local, caches, tuple(lbatch["tokens"].shape), "prefill")
    args = _nbytes(local, lbatch, caches)
    with CostCounter(external=tree.leaves((local, lbatch, caches)),
                     track_peak=track_peak) as cc:
        logits, caches = mdl.prefill(local, cfg, lbatch, caches,
                                     layout=layout)
    return {"cost": cc.result(), "argument_bytes": args,
            "output_bytes": _nbytes(logits, caches),
            "host_argument_bytes": 0, "expected_collectives": expected,
            "batch_axes": layout.batch_axes}


def trace_decode(cfg, mesh, shape, *, track_peak: bool = True) -> dict:
    """One decode step (the reference's ``lower_decode``) of this rank, at
    the cache's last position."""
    local, caches, _, layout = _serve_inputs(cfg, mesh, shape)
    token = _local_batch({"tokens": torch.empty(
        (shape.global_batch, 1), dtype=torch.int32, device="meta")},
        layout)["tokens"]
    expected = sharded.serve_collectives(cfg, layout, local, caches,
                                         tuple(token.shape), "decode")
    args = _nbytes(local, token, caches)
    with CostCounter(external=tree.leaves((local, token, caches)),
                     track_peak=track_peak) as cc:
        logits, caches = mdl.decode_step(local, cfg, token,
                                         shape.seq_len - 1, caches,
                                         layout=layout)
    return {"cost": cc.result(), "argument_bytes": args,
            "output_bytes": _nbytes(logits, caches),
            "host_argument_bytes": 0, "expected_collectives": expected,
            "batch_axes": layout.batch_axes}


def trace(cfg, mesh, shape, *, schedule: str = "vertical",
          microbatches: int = 8, fsdp_batch: bool = False,
          host_offload: bool = False, track_peak: bool = True) -> dict:
    """The step ``shape.kind`` names, traced on the bound ``mesh``."""
    if shape.kind == "train":
        return trace_train(cfg, mesh, shape, schedule=schedule,
                           microbatches=microbatches, fsdp_batch=fsdp_batch,
                           host_offload=host_offload, track_peak=track_peak)
    if shape.kind == "prefill":
        return trace_prefill(cfg, mesh, shape, track_peak=track_peak)
    return trace_decode(cfg, mesh, shape, track_peak=track_peak)


# ---------------------------------------------------------------------------
# Run one combination
# ---------------------------------------------------------------------------

def record(cfg, mesh, shape, *, arch: str, shape_name: str, mesh_name: str,
           schedule: str = "vertical", microbatches: int = 8,
           fsdp_batch: bool = False, host_offload: bool = False) -> Dict:
    """The record of one traced step; raises if its collective counts
    differ from their closed form."""
    t0 = time.time()
    tr = trace(cfg, mesh, shape, schedule=schedule,
               microbatches=microbatches, fsdp_batch=fsdp_batch,
               host_offload=host_offload)
    t_trace = time.time() - t0
    cost = tr["cost"]
    if not sharded.counts_equal(cost.collectives,
                                tr["expected_collectives"]):
        raise RuntimeError(f"collectives {cost.collectives} differ from "
                           f"their closed form {tr['expected_collectives']}")
    train = shape.kind == "train"
    return {
        "arch": arch,
        "shape": shape_name,
        "mesh": mesh_name,
        "chips": mesh.size,
        "schedule": schedule if train else shape.kind,
        "sharding": "fsdp" if fsdp_batch else "tp",
        "host_offload": host_offload,
        "microbatches": microbatches if train else None,
        "trace_s": round(t_trace, 1),
        "flops_per_device": cost.flops,
        "bytes_accessed_per_device": cost.bytes_accessed,
        "memory": {
            "argument_bytes": tr["argument_bytes"],
            "output_bytes": tr["output_bytes"],
            "host_argument_bytes": tr["host_argument_bytes"],
            "peak_estimate_bytes": cost.peak_bytes,
        },
        "collectives": cost.collectives,
        "collectives_closed_form": tr["expected_collectives"],
        "batch_axes": list(tr["batch_axes"]),
        "total_params": cfg.total_params(),
        "active_params": cfg.active_params(),
    }


def _check_out_dir(out_dir: str) -> None:
    if os.path.realpath(out_dir) == os.path.realpath(_REFERENCE_OUT):
        raise ValueError(f"{out_dir} holds the reference's records; the "
                         f"port writes to {OUT_DIR}")


def run_one(arch: str, shape_name: str, multi_pod: bool, *,
            schedule: str = "vertical", microbatches: int = 8,
            out_dir: str = OUT_DIR, fsdp_batch: bool = False,
            host_offload: bool = False) -> Dict:
    """Trace one combination on the production mesh (this process joins
    a fake world of its size) and write its record."""
    _check_out_dir(out_dir)
    mesh_name = "2x16x16" if multi_pod else "16x16"
    rec = record(get_config(arch), production_mesh(multi_pod),
                 INPUT_SHAPES[shape_name], arch=arch, shape_name=shape_name,
                 mesh_name=mesh_name, schedule=schedule,
                 microbatches=microbatches, fsdp_batch=fsdp_batch,
                 host_offload=host_offload)
    os.makedirs(out_dir, exist_ok=True)
    sfx = ("_fsdp" if fsdp_batch else "") + ("_host" if host_offload else "")
    fname = f"{arch}_{shape_name}_{mesh_name}_{schedule}{sfx}.json"
    with open(os.path.join(out_dir, fname), "w") as f:
        json.dump(rec, f, indent=1)
    return rec


def bound_mesh(name: str):
    """``"16x16"`` / ``"2x16x16"`` (the production meshes) or ``"DxM"``
    (a data x model host mesh), bound to a fake world of its size."""
    if name in ("16x16", "2x16x16"):
        return production_mesh(name == "2x16x16")
    data, model = (int(n) for n in name.split("x"))
    join_fake_world(data * model)
    return mesh_lib.make_host_mesh(data, model)


def trace_records(items, mesh_name: str) -> List[Dict]:
    """The records of ``items`` — ``(cfg, InputShape, options)`` with
    :func:`record`'s keyword options — on the bound mesh ``mesh_name``
    (for :func:`spawn`: the process joins the mesh's fake world)."""
    mesh = bound_mesh(mesh_name)
    return [record(cfg, mesh, shape, arch=cfg.name, shape_name=shape.name,
                   mesh_name=mesh_name, **opts)
            for cfg, shape, opts in items]


def _call(fn, args, kwargs):
    return fn(*args, **kwargs)


def spawn(fn, *args, **kwargs):
    """``fn(*args, **kwargs)`` in a spawned process of its own (the fake
    process group is global to a process) and its result; ``fn`` must be
    importable."""
    import multiprocessing as mp
    from concurrent.futures import ProcessPoolExecutor
    with ProcessPoolExecutor(1, mp_context=mp.get_context("spawn")) as ex:
        return ex.submit(_call, fn, args, kwargs).result()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="all",
                    help="arch id or 'all' (assigned pool)")
    ap.add_argument("--shape", default="all",
                    help="input shape name or 'all'")
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--schedule", default="vertical",
                    choices=["vertical", "horizontal"])
    ap.add_argument("--microbatches", type=int, default=8)
    ap.add_argument("--fsdp", action="store_true",
                    help="batch over every axis where it divides, params "
                         "fully sharded and gathered at use, expert "
                         "parallelism for MoE stacks")
    ap.add_argument("--host-offload", action="store_true",
                    help="count the optimizer states as host bytes (the "
                         "paper's CPU-resident states)")
    ap.add_argument("--out", default=OUT_DIR)
    args = ap.parse_args(argv)
    _check_out_dir(args.out)

    archs = ASSIGNED_ARCHS if args.arch == "all" else [args.arch]
    shapes = list(INPUT_SHAPES) if args.shape == "all" else [args.shape]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    failed = 0
    # mesh outermost: the process joins each fake world once
    for mp in meshes:
        for arch in archs:
            for shape in shapes:
                tag = f"{arch} x {shape} x {'2x16x16' if mp else '16x16'}"
                if not supports_shape(arch, shape):
                    print(f"SKIP {tag} (long-context ineligible)",
                          flush=True)
                    continue
                try:
                    rec = run_one(arch, shape, mp, schedule=args.schedule,
                                  microbatches=args.microbatches,
                                  out_dir=args.out, fsdp_batch=args.fsdp,
                                  host_offload=args.host_offload)
                    peak = rec["memory"]["peak_estimate_bytes"] / 1e9
                    print(f"OK   {tag}: trace={rec['trace_s']}s "
                          f"flops/dev={rec['flops_per_device']:.3e} "
                          f"peak/dev={peak:.2f}GB", flush=True)
                except Exception as e:  # noqa: BLE001 -- reported, counted
                    failed += 1
                    print(f"FAIL {tag}: {type(e).__name__}: {e}", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
