"""End-to-end example: train a ~100M-parameter GPT for a few hundred
steps with the GreedySnake vertical schedule + α-delayed optimizer.

    python -m repro_torch.examples.train_gpt100m [--steps 200] [--device cpu]

This is the deliverable-(b) end-to-end example: real data pipeline
(synthetic LM stream), schedule, mixed-precision Adam, checkpointing,
and metrics. Runs on the CUDA card (attention through the hand-written
Hopper kernels), or on the CPU with ``--device cpu``.
"""
import argparse
import tempfile
from typing import Dict, List, Optional

import torch

from repro_torch import tree
from repro_torch.configs import get_config
from repro_torch.core.schedules import ScheduleConfig
from repro_torch.optim import AdamConfig
from repro_torch.train import Trainer
from repro_torch.train.checkpoint import restore, save


def main(argv: Optional[List[str]] = None) -> Dict[str, object]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--microbatches", type=int, default=4)
    ap.add_argument("--alpha", type=float, default=0.25)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config("gpt-100m")
    print(f"training {cfg.name}: {cfg.total_params() / 1e6:.0f}M params, "
          f"{args.steps} steps, batch {args.batch} x seq {args.seq}, "
          f"alpha={args.alpha}")
    sched = ScheduleConfig(schedule="vertical",
                           num_microbatches=args.microbatches,
                           alpha=args.alpha, clip_norm=1.0)
    tr = Trainer(cfg, sched, AdamConfig(lr=6e-4), device=args.device)
    rep = tr.run(args.steps, args.batch, args.seq, log_every=20)

    ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(prefix="gs_ckpt_")
    save(ckpt_dir, tr.params, step=tr.step_num)
    restored, _, step = restore(ckpt_dir, tr.params)
    n = sum(x.numel() for x in tree.leaves(restored))
    print(f"\nfinal loss {rep.losses[-1]:.4f} "
          f"(start {rep.losses[0]:.4f}); {rep.tokens_per_s:.0f} tok/s")
    print(f"checkpoint: {ckpt_dir} (step {step}, {n / 1e6:.0f}M params)")
    if not rep.losses[-1] < rep.losses[0] - 1.0:
        raise SystemExit(f"training must make progress: loss "
                         f"{rep.losses[0]:.4f} -> {rep.losses[-1]:.4f}")
    print("OK")
    return {"losses": rep.losses, "tokens_per_s": rep.tokens_per_s,
            "checkpoint": ckpt_dir, "step": step, "params": n,
            "restored_equal": all(
                torch.equal(a, b) for a, b in
                zip(tree.leaves(tr.params), tree.leaves(restored)))}


if __name__ == "__main__":
    main()
