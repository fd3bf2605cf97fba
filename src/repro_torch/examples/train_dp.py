"""Data-parallel SSD-offloaded training: R rank workers × R SSD path
sets, ZeRO-style sharded optimizer state, deterministic collectives.

    python -m repro_torch.examples.train_dp [--ranks 2] [--steps 6]
        [--paths-per-rank 1] [--cap-ssd-mbs 0] [--verify-single-rank]
        [--device cpu]

Each rank owns a contiguous 1/R element range of every tiered vector
(low-precision params, master, momentum, variance) on its OWN I/O
engine + SSD directory set, all-gathers params per layer boundary and
reduce-scatters layer gradients — see ``repro_torch.offload.dp``; the R
ranks are simulated on the one device. With ``--verify-single-rank`` the
same seed/batches are replayed on the single-rank engine and the
per-step losses are compared bit-for-bit (they must be identical in
f32, §6.5 extended across the DP axis).

Prints per-step loss, each rank's traffic by (category, route) —
validated against ``repro_torch.core.traffic.dp_vertical_traffic`` in
the test suite — and the aggregate interconnect volume.
"""
import argparse
import os
import tempfile
import time
from typing import Dict, List, Optional

from repro_torch import deterministic
from repro_torch.configs import get_config
from repro_torch.core.perfmodel import StorageRatios
from repro_torch.core.traffic import dp_vertical_traffic
from repro_torch.data import SyntheticLM
from repro_torch.io import IOConfig
from repro_torch.offload import (DataParallelOffloadEngine, OffloadConfig,
                                 OffloadEngine)


def main(argv: Optional[List[str]] = None) -> Dict[str, object]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--microbatches", type=int, default=4)
    ap.add_argument("--micro-batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--alpha", type=float, default=0.25)
    ap.add_argument("--paths-per-rank", type=int, default=1)
    ap.add_argument("--cap-ssd-mbs", type=float, default=0.0)
    ap.add_argument("--verify-single-rank", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    with deterministic(args.verify_single_rank):
        return run(args)


def run(args) -> Dict[str, object]:
    cfg = get_config("gpt-tiny")
    M, mb, R = args.microbatches, args.micro_batch, args.ranks
    ocfg_kw = dict(schedule="vertical", num_microbatches=M, micro_batch=mb,
                   seq_len=args.seq, alpha=args.alpha, lr=3e-3,
                   ratios=StorageRatios(ckpt=0.5, param=0.5, opt=0.0))
    bandwidth = {}
    if args.cap_ssd_mbs > 0:
        bandwidth = {"cpu->ssd": args.cap_ssd_mbs * 1e6,
                     "ssd->cpu": args.cap_ssd_mbs * 1e6}

    out: Dict[str, object] = {}
    with tempfile.TemporaryDirectory(prefix="greedysnake_dp_") as root:
        paths = [os.path.join(root, f"nvme{i}")
                 for i in range(R * args.paths_per_rank)]
        eng = DataParallelOffloadEngine(
            cfg, OffloadConfig(io=IOConfig(paths=paths, bandwidth=bandwidth),
                               **ocfg_kw),
            0, root, ranks=R, device=args.device)
        try:
            print(f"{R} ranks × {args.paths_per_rank} path(s) each; "
                  f"shard bounds {eng.bounds} of P={eng.P} per layer")
            data = SyntheticLM(cfg.vocab_size, seed=0)
            t0 = time.perf_counter()
            losses = []
            for i in range(args.steps):
                loss = eng.train_step(data.batch(M * mb, args.seq))
                losses.append(loss)
                print(f"step {i + 1:3d}  loss {loss:8.4f}")
            eng.finish()
            dt = time.perf_counter() - t0
            print(f"\n{args.steps} steps, {dt / args.steps:.2f} s/step, "
                  f"R={R}, alpha={args.alpha}")

            ms = eng.L * eng.P * 4
            cs = cfg.num_layers * mb * args.seq * cfg.d_model * 4
            t = dp_vertical_traffic(ms, cs, M, R, grad_bytes=ms,
                                    os_bytes=3 * ms, n_layers=eng.L)
            print(f"closed form per rank/step: param fetch "
                  f"{t.param_fetch / 1e9:.3f} GB (2·ms/R), all-gather "
                  f"{t.param_allgather / 1e9:.3f} GB, reduce-scatter "
                  f"{t.grad_reducescatter / 1e9:.3f} GB")
            traffic = eng.traffic()
            for r, snap in enumerate(traffic):
                print(f"\nrank {r} traffic (GB per category:route):")
                for key, v in sorted(snap.items()):
                    if v:
                        print(f"  {key:22s} {v / 1e9:8.3f}")
            agg_ic = sum(v for snap in traffic
                         for k, v in snap.items() if "net" in k)
            print(f"\naggregate interconnect volume: {agg_ic / 1e9:.3f} GB")
        finally:
            eng.close()
        out.update(losses=losses, s_per_step=dt / args.steps,
                   traffic=traffic, closed_form=t)

        if args.verify_single_rank:
            print("\nreplaying on the single-rank engine ...")
            with tempfile.TemporaryDirectory() as d1:
                ref = OffloadEngine(cfg, OffloadConfig(**ocfg_kw), 0, d1,
                                    device=args.device)
                try:
                    data = SyntheticLM(cfg.vocab_size, seed=0)
                    ref_losses = [ref.train_step(data.batch(M * mb,
                                                            args.seq))
                                  for _ in range(args.steps)]
                    ref.finish()
                finally:
                    ref.close()
            match = losses == ref_losses
            print("bit-identical loss trajectory:", match)
            out.update(single_rank_losses=ref_losses, match=match)
            if not match:
                for i, (a, b) in enumerate(zip(losses, ref_losses)):
                    if a != b:
                        print(f"  step {i + 1}: dp={a!r} single={b!r}")
                raise SystemExit(1)
    print("OK")
    return out


if __name__ == "__main__":
    main()
