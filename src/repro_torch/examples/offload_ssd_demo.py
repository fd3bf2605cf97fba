"""SSD-offloaded training with the REAL three-tier engine: parameters
and optimizer states live in files ("SSD") and host buffers ("CPU"),
moved layer-by-layer through the vertical pipeline with overlapped
CPU-Adam — the runnable counterpart of the paper's system.

    python -m repro_torch.examples.offload_ssd_demo [--schedule vertical]
        [--io-paths 2] [--cap-ssd-mbs 500] [--device cpu]

Every byte flows through the port's ``repro_torch.io`` engine: pass
``--io-paths N`` to stripe the SSD tier across N directories
(MLP-Offload-style multi-path) and ``--cap-ssd-mbs`` to pace the SSD link
with the token-bucket simulator, turning the perf model's rooflines into
wall-clock effects.

Prints per-iteration loss, the measured traffic by (category, route) —
held to the paper's closed-form §3.4 predictions for the parameter loads
and the f32 gradient swaps — the I/O-engine scheduling stats, and the
phase wall-times showing optimizer overlap.
"""
import argparse
import os
import tempfile
import time
from typing import Dict, List, Optional

from repro_torch.configs import get_config
from repro_torch.core.perfmodel import StorageRatios
from repro_torch.core.traffic import horizontal_traffic, vertical_traffic
from repro_torch.data import SyntheticLM
from repro_torch.io import IOConfig
from repro_torch.offload import OffloadConfig, OffloadEngine


def main(argv: Optional[List[str]] = None) -> Dict[str, object]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--schedule", default="vertical",
                    choices=["vertical", "horizontal"])
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--microbatches", type=int, default=4)
    ap.add_argument("--micro-batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--alpha", type=float, default=0.25)
    ap.add_argument("--io-paths", type=int, default=1,
                    help="stripe the SSD tier across this many directories")
    ap.add_argument("--chunk-kb", type=int, default=1024)
    ap.add_argument("--cap-ssd-mbs", type=float, default=0.0,
                    help="simulate an SSD bandwidth cap (MB/s, 0 = off)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config("gpt-tiny")
    M, mb = args.microbatches, args.micro_batch
    with tempfile.TemporaryDirectory(prefix="greedysnake_ssd_") as ssd:
        paths = [os.path.join(ssd, f"nvme{i}") for i in range(args.io_paths)]
        bandwidth = {}
        if args.cap_ssd_mbs > 0:
            bandwidth = {"cpu->ssd": args.cap_ssd_mbs * 1e6,
                         "ssd->cpu": args.cap_ssd_mbs * 1e6}
        iocfg = IOConfig(paths=paths, chunk_bytes=args.chunk_kb << 10,
                         bandwidth=bandwidth)
        print(f"SSD tier: {args.io_paths} path(s) under {ssd}"
              + (f", capped at {args.cap_ssd_mbs:.0f} MB/s" if bandwidth
                 else ""))
        eng = OffloadEngine(cfg, OffloadConfig(
            schedule=args.schedule, num_microbatches=M, micro_batch=mb,
            seq_len=args.seq, alpha=args.alpha if args.schedule == "vertical"
            else 0.0, lr=3e-3,
            ratios=StorageRatios(ckpt=0.5, param=0.5, opt=0.0),
            io=iocfg), 0, ssd, device=args.device)
        try:
            data = SyntheticLM(cfg.vocab_size, seed=0)
            eng.meter.reset()
            losses = []
            t0 = time.perf_counter()
            for i in range(args.steps):
                loss = eng.train_step(data.batch(M * mb, args.seq))
                losses.append(loss)
                print(f"step {i + 1:3d}  loss {loss:8.4f}")
            eng.finish()
            dt = time.perf_counter() - t0

            print(f"\n{args.steps} steps, {dt / args.steps:.2f} s/step, "
                  f"schedule={args.schedule}, alpha={args.alpha}")
            print("\nmeasured traffic (GB per category:route):")
            snap = eng.meter.snapshot()
            for key, v in sorted(snap.items()):
                print(f"  {key:20s} {v / 1e9:8.3f}")
            form = (vertical_traffic if args.schedule == "vertical"
                    else horizontal_traffic)
            # the closed forms count the model in bf16 (2 bytes a
            # parameter): the loads scale with the engine's parameter
            # bytes, the gradient swaps are f32, 2 x a bf16 model
            cs = cfg.num_layers * mb * args.seq * cfg.d_model * 4
            pred = form(eng.L * eng.P * eng.dtype.itemsize, cs, M)
            grad_pred = form(eng.L * eng.P * 2, cs, M).grad_swap
            print(f"\npaper closed form (params+grads, per step): "
                  f"load {pred.param_load / 1e9:.3f} GB + "
                  f"grad {grad_pred / 1e9:.3f} GB")
            load = snap.get("param:cpu->gpu", 0) / args.steps
            grad = (snap.get("grad:gpu->cpu", 0)
                    + snap.get("grad:cpu->gpu", 0)) / args.steps
            closed_ok = load == pred.param_load and grad == grad_pred
            print(f"measured per step: load {load / 1e9:.3f} GB + grad "
                  f"{grad / 1e9:.3f} GB -> "
                  f"{'== closed form' if closed_ok else '!= closed form'}")
            st = eng.metrics_snapshot()
            io = st["io"][0]              # per-rank list; single rank here
            print(f"\nio engine: {io['submitted']} requests "
                  f"({io['cancelled']} cancelled), {io['chunk_ops']} chunk "
                  f"ops over {io['num_paths']} path(s), "
                  f"peak in-flight {io['max_inflight_bytes'] / 1e6:.1f} MB")
            print("  bytes by priority:",
                  {k: f"{v / 1e9:.3f} GB"
                   for k, v in io["bytes_by_priority"].items() if v})
            print(f"host residency peak: "
                  f"{st['host_peak_nbytes'][0] / 1e6:.1f} MB")
            print("phase seconds:",
                  {k: round(v, 2) for k, v in eng.phase_time.items()})
        finally:
            eng.close()
    if not closed_ok:
        raise SystemExit(f"measured traffic (load {load}, grad {grad} B per "
                         f"step) != the closed forms ({pred.param_load}, "
                         f"{grad_pred})")
    print("OK")
    return {"losses": losses, "s_per_step": dt / args.steps,
            "traffic": snap, "param_load": load, "grad_swap": grad,
            "closed_param_load": pred.param_load,
            "closed_grad_swap": grad_pred}


if __name__ == "__main__":
    main()
