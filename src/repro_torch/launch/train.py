"""Training launcher CLI of the port.

Runs a REAL training loop on the card (``--device``, default ``cuda``),
in memory through :class:`repro_torch.train.Trainer`, or SSD-offloaded
through the port's GreedySnake engine (``--offload``).

Examples:
  python -m repro_torch.launch.train --arch gpt-tiny --steps 20
  python -m repro_torch.launch.train --arch gpt-100m --steps 200 \\
      --schedule vertical --offload --alpha 0.2 --microbatches 4
  python -m repro_torch.launch.train --arch gpt-tiny --steps 2 --device cpu

``main(argv)`` prints the reference CLI's lines and returns what it
printed as numbers: the per-step losses and tokens/s, and under
``--offload`` also the engine's byte meters, its ``plan_traffic`` for one
step and the engine itself (closed).
"""
from __future__ import annotations

import argparse
import tempfile
import time
from typing import Dict, List, Optional

import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config, get_smoke
from repro_torch.core.perfmodel import StorageRatios
from repro_torch.core.plan import PlanCosts, plan_traffic
from repro_torch.core.schedules import ScheduleConfig
from repro_torch.data import SyntheticLM
from repro_torch.models import model as mdl
from repro_torch.offload import OffloadConfig, OffloadEngine, offload_state
from repro_torch.optim import AdamConfig
from repro_torch.train import Trainer


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gpt-tiny")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced smoke variant of the arch")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--schedule", default="vertical",
                    choices=["vertical", "horizontal"])
    ap.add_argument("--microbatches", type=int, default=4)
    ap.add_argument("--alpha", type=float, default=0.0)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--offload", action="store_true",
                    help="run through the SSD-offload engine")
    ap.add_argument("--ssd-dir", default=None)
    ap.add_argument("--x-ckpt", type=float, default=0.5)
    ap.add_argument("--x-param", type=float, default=0.5)
    ap.add_argument("--x-opt", type=float, default=0.0)
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (cpu runs the "
                         "kernels' plain versions)")
    return ap.parse_args(argv)


def run_offload(cfg, args) -> Dict[str, object]:
    """``--offload``: the port's ``OffloadEngine`` from the port's seed-0
    params (``init_params(cfg, 0)`` in f32, the engine's default param
    dtype), fed ``SyntheticLM(vocab, seed=0)`` batches."""
    workdir = args.ssd_dir or tempfile.mkdtemp(prefix="greedysnake_ssd_")
    print(f"SSD tier: {workdir}")
    ocfg = OffloadConfig(
        schedule=args.schedule, num_microbatches=args.microbatches,
        micro_batch=args.batch // args.microbatches, seq_len=args.seq,
        alpha=args.alpha, lr=args.lr,
        ratios=StorageRatios(args.x_ckpt, args.x_param, args.x_opt))
    params = offload_state(cfg, mdl.init_params(cfg, 0, dtype=torch.float32,
                                                device=args.device))
    eng = OffloadEngine(cfg, ocfg, 0, workdir, params=params,
                        device=args.device)
    del params
    data = SyntheticLM(cfg.vocab_size, seed=0)
    losses = []
    try:
        t0 = time.perf_counter()
        for i in range(args.steps):
            loss = eng.train_step(data.batch(args.batch, args.seq))
            losses.append(loss)
            print(f"step {i + 1:4d} loss {loss:8.4f}", flush=True)
        eng.finish()
        dt = time.perf_counter() - t0
        tps = args.steps * args.batch * args.seq / dt
        print(f"\n{args.steps} steps in {dt:.1f}s ({tps:.0f} tokens/s)")
        print("traffic by category (GB):")
        snap = eng.meter.snapshot()
        for k, v in sorted(snap.items()):
            print(f"  {k:24s} {v / 1e9:10.3f}")
        print("phase seconds:", {k: round(v, 2)
                                 for k, v in eng.phase_time.items()})
        pred = plan_traffic(eng.plan, PlanCosts.from_engine(eng))
    finally:
        eng.close()
    return {"losses": losses, "seconds": dt, "tokens_per_s": tps,
            "traffic": snap, "plan_traffic": dict(pred),
            "phase_time": dict(eng.phase_time), "engine": eng}


def run_in_memory(cfg, args) -> Dict[str, object]:
    sched = ScheduleConfig(schedule=args.schedule,
                           num_microbatches=args.microbatches,
                           alpha=args.alpha)
    tr = Trainer(cfg, sched, AdamConfig(lr=args.lr), device=args.device)
    rep = tr.run(args.steps, args.batch, args.seq)
    print(f"\nfinal loss {rep.losses[-1]:.4f}  "
          f"{rep.tokens_per_s:.0f} tokens/s")
    return {"losses": rep.losses, "steps_per_s": rep.steps_per_s,
            "tokens_per_s": rep.tokens_per_s}


def main(argv: Optional[List[str]] = None) -> Dict[str, object]:
    args = parse_args(argv)
    args.device = resolve_device(args.device)
    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    if args.offload:
        return run_offload(cfg, args)
    return run_in_memory(cfg, args)


if __name__ == "__main__":
    main()
