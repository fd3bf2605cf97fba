#!/usr/bin/env python3
"""Which ``torch.distributed`` collectives the ``gloo`` backend takes on
CUDA tensors, with ranks that share one card.

NCCL refuses two ranks on one GPU, so the port's multi-rank runs on a
one-card machine use ``gloo``. This script spawns ``--ranks`` processes
(file store, one thread each), all on ``cuda:0``, and tries each op the
port's collective layer uses on CUDA tensors in f32 and bf16: whether it
runs, whether its result is right, and its time beside the same op on a
host copy (``.cpu()`` -> op -> ``.to(device)``). It also tries
``init_device_mesh("cuda", (2, ranks // 2))`` over the ``gloo`` group.
Prints one JSON line per op and one summary line.

    python3 tools/gloo_cuda_probe.py [--ranks 4] [--mib 64]
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
import traceback

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))


def _ops(torch, dist, world, rank):
    """name -> fn(x) that runs the op on ``x`` (rank's chunk) and returns
    (result, expected)."""
    def all_gather(x):
        out = x.new_empty((world * x.shape[0],) + x.shape[1:])
        dist.all_gather_into_tensor(out, x.contiguous())
        exp = torch.cat([x.cpu() * 0 + r for r in range(world)]).to(x.device)
        return out, exp

    def all_gather_list(x):
        outs = [torch.empty_like(x) for _ in range(world)]
        dist.all_gather(outs, x)
        exp = torch.cat([x.cpu() * 0 + r for r in range(world)])
        return torch.cat(outs), exp.to(x.device)

    def reduce_scatter(x):
        full = torch.cat([x] * world)
        out = torch.empty_like(x)
        dist.reduce_scatter_tensor(out, full)
        return out, x * 0 + sum(range(world))

    def reduce_scatter_list(x):
        out = torch.empty_like(x)
        dist.reduce_scatter(out, [x.clone() for _ in range(world)])
        return out, x * 0 + sum(range(world))

    def all_to_all_single(x):
        src = torch.cat([x * 0 + rank * world + j for j in range(world)])
        out = torch.empty_like(src)
        dist.all_to_all_single(out, src)
        exp = torch.cat([x * 0 + j * world + rank for j in range(world)])
        return out, exp

    def all_reduce(x):
        y = x.clone()
        dist.all_reduce(y)
        return y, x * 0 + sum(range(world))

    return {"all_gather_into_tensor": all_gather,
            "all_gather": all_gather_list,
            "reduce_scatter_tensor": reduce_scatter,
            "reduce_scatter": reduce_scatter_list,
            "all_to_all_single": all_to_all_single,
            "all_reduce": all_reduce}


def _worker(rank, world, store, mib, out_dir):
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            world_size=world, rank=rank)
    dev = torch.device("cuda", 0)
    rows = []
    for name, fn in _ops(torch, dist, world, rank).items():
        for dtype in (torch.float32, torch.bfloat16):
            n = mib * 2**20 // (torch.finfo(dtype).bits // 8) // world
            row = {"op": name, "dtype": str(dtype).split(".")[-1],
                   "bytes_per_rank": n * torch.finfo(dtype).bits // 8}
            for where in ("cuda", "host"):
                x = torch.full((n,), float(rank), dtype=dtype, device=dev)
                try:
                    dist.barrier()
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    if where == "cuda":
                        y, exp = fn(x)
                    else:
                        y, exp = fn(x.cpu())
                        y, exp = y.to(dev), exp.to(dev)
                    torch.cuda.synchronize()
                    row[f"{where}_s"] = time.perf_counter() - t0
                    row[f"{where}_ok"] = bool(torch.equal(y, exp))
                except Exception as e:   # a probe records refusals
                    row[f"{where}_ok"] = False
                    row[f"{where}_error"] = (f"{type(e).__name__}: "
                                             f"{str(e)[:300]}")
                    # a refused op leaves the group usable for the next
            rows.append(row)
    mesh = {}
    try:
        from torch.distributed.device_mesh import init_device_mesh
        dm = init_device_mesh("cuda", (2, world // 2),
                              mesh_dim_names=("data", "model"))
        g = dm.get_group("model")
        y = torch.ones(4, device=dev)
        dist.all_reduce(y, group=g)
        mesh = {"ok": bool(torch.equal(y, torch.full_like(y, world // 2))),
                "model_group_size": dist.get_world_size(g)}
    except Exception as e:
        mesh = {"ok": False, "error": f"{type(e).__name__}: {str(e)[:300]}",
                "trace": traceback.format_exc()[-800:]}
    if rank == 0:
        with open(os.path.join(out_dir, "probe.json"), "w") as f:
            json.dump({"rows": rows, "device_mesh": mesh,
                       "torch": torch.__version__,
                       "cuda": torch.version.cuda}, f)
    dist.barrier()
    dist.destroy_process_group()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--mib", type=int, default=64)
    args = ap.parse_args()
    import torch
    import torch.multiprocessing as mp
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        ctx = mp.spawn(_worker, args=(args.ranks, os.path.join(d, "store"),
                                      args.mib, d),
                       nprocs=args.ranks, join=False)
        deadline = time.monotonic() + 300
        while not ctx.join(timeout=5):
            if time.monotonic() > deadline:
                for p in ctx.processes:
                    p.kill()
                print("probe: ranks timed out", file=sys.stderr)
                return 1
        with open(os.path.join(d, "probe.json")) as f:
            rec = json.load(f)
    for row in rec["rows"]:
        print(json.dumps(row))
    print("device_mesh: " + json.dumps(rec["device_mesh"]))
    print(json.dumps({"torch": rec["torch"], "cuda": rec["cuda"],
                      "ranks": args.ranks,
                      "wall_s": time.perf_counter() - t0,
                      "cuda_ok": {r["op"] + "/" + r["dtype"]: r["cuda_ok"]
                                  for r in rec["rows"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
