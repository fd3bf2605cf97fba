"""Quickstart: train a small GPT with GreedySnake's vertical schedule.

    python -m repro_torch.examples.quickstart [--wave W]
        [--activation-policy recompute|spill|auto] [--trace out.json]
        [--autotune] [--hetero-paths] [--chaos] [--device cpu]

Shows the core public APIs of the port:
  1. configs      — pick an architecture (any of the port's registry,
                    ``repro_torch.configs``, works via get_smoke)
  2. ScheduleConfig / Trainer — vertical vs horizontal schedules
  3. the schedule-equivalence identity — both produce the same gradients
  4. the offload engine's wave-schedule knob — one compiled
     repro_torch.core.plan per W, interpolating between horizontal (W=1)
     and vertical (W=M) storage traffic
  5. the activation-policy knob — "spill" streams each layer's saved
     tensors through the SSD tier (SPILL_ACT/FETCH_ACT at the
     opportunistic IOPriority.ACT) instead of recomputing backward,
     with BITWISE-identical losses; "auto" asks the perf model
  6. the cross-stream lookahead knob — --prefetch-depth places the
     PREFETCH/PREFETCH_CKPT/PREFETCH_ACT/PREFETCH_OPT hints that many
     fetches ahead (0 disables the hints AND the cross-iteration
     α-tail seam); losses are bitwise-identical at every depth, only
     the prefetch hit rate and stall-seconds move
  7. the observability stack — --trace out.json runs a traced engine,
     exports a Perfetto-loadable Chrome trace (one track per I/O
     channel thread + the executor's plan ops + its host work — copies,
     syncs, optimizer waits — + the hint streams), on the time base of
     ``torch.profiler``'s Chrome export: open it in Perfetto beside a
     ``prof.export_chrome_trace`` of the same window and the two line
     up (``Tracer.to_unix_ns`` maps a stamp onto the profiler's event
     clock), and prints the
     ``obs.reconcile`` plan-vs-actual table: every (category, route)
     byte counter measured by the run against the ``plan_traffic``
     prediction, EXACT row by row, plus the stall attribution
  8. the online autotuner — --autotune attaches an
     ``AutotuneController``: every window it measures live route
     rates from the chunk spans (``machine_from_snapshot``), re-runs
     Algorithm 1 per candidate plan, and hot-swaps the engine's plan
     between iterations when the predicted win clears hysteresis
     (gated on the reconcile error), then prints the decision log
  9. dynamic per-path placement — --hetero-paths runs the engine on a
     2-path paced device with a 4:1 per-path rate split: under
     ``path_policy="static"`` the ``i % P`` stripe pays 2x the slow
     cap, under ``"backlog"`` chunk placement drains toward
     sum-of-caps (per-path achieved rates printed from the tracer);
     then the autotuner, fed the static run's LIVE per-path rates,
     prices both policies (``machine_for_path_policy``) and retunes
     ``path_policy`` static -> backlog
 10. the resilient I/O fabric — --chaos installs
     ``repro_torch.io.chaos.ChaosFiles`` on a training engine and
     injects seeded transient faults into every chunk op: with
     ``IOConfig.integrity`` + bounded retries the run stays BITWISE
     identical to its fault-free twin; then a crash-consistent
     checkpoint (``save_checkpoint`` / ``restore_checkpoint``) round
     trips the whole optimizer state through disk into a FRESH engine
     and training resumes bitwise

``main(argv)`` returns each section's numbers and identities.
"""
import argparse
import tempfile
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch import deterministic, resolve_device, tree
from repro_torch.configs import get_config
from repro_torch.core.perfmodel import MachineParams, StorageRatios
from repro_torch.core.schedules import (ScheduleConfig, grads_fn,
                                        init_train_state)
from repro_torch.data import make_batch
from repro_torch.io import IOConfig
from repro_torch.offload import (AutotuneConfig, AutotuneController,
                                 OffloadConfig, OffloadEngine)
from repro_torch.optim import AdamConfig
from repro_torch.train import Trainer


def parse_args(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("--wave", type=int, default=2, choices=[1, 2, 4],
                    help="wave size W for the offload-engine demo's M=4 "
                         "(W=1 horizontal ... W=4 vertical)")
    ap.add_argument("--activation-policy", default="recompute",
                    choices=["recompute", "spill", "auto"],
                    help="backward from recomputed activations (paper) "
                         "or from SSD-streamed saved tensors (SSDTrain); "
                         "auto prices both with the perf model")
    ap.add_argument("--prefetch-depth", type=int, default=2,
                    help="cross-stream lookahead depth for the adaptive-"
                         "pipeline demo (0 = hints off; the engine "
                         "rejects negative or absurd depths)")
    ap.add_argument("--trace", default="", metavar="OUT.json",
                    help="run the observability demo: export a Chrome "
                         "trace-event JSON here (on torch.profiler's "
                         "Chrome-trace time base: open it in Perfetto "
                         "beside a profiler trace of the same window) and "
                         "print the plan-vs-actual reconciliation table")
    ap.add_argument("--autotune", action="store_true",
                    help="run the online-autotuner demo: script an SSD "
                         "slowdown into the live-rate feed and watch "
                         "the controller re-solve Algorithm 1 and "
                         "hot-swap the plan mid-training")
    ap.add_argument("--hetero-paths", action="store_true",
                    help="run the dynamic-placement demo: static vs "
                         "backlog chunk placement on a paced 4:1 "
                         "two-path device, then the autotuner's "
                         "path_policy retune off the live per-path "
                         "rates")
    ap.add_argument("--chaos", action="store_true",
                    help="run the resilience demo: transient chunk "
                         "faults absorbed bitwise by integrity+retry, "
                         "then a crash-consistent checkpoint restore "
                         "into a fresh engine")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def check(ok: bool, msg: str) -> None:
    """The example's own identities: a failure ends the run."""
    if not ok:
        raise SystemExit(f"quickstart: {msg}")


def main(argv: Optional[List[str]] = None) -> Dict[str, object]:
    args = parse_args(argv)
    device = resolve_device(args.device)
    # the sections hold bitwise identities between separate runs
    with deterministic(device.type == "cuda"):
        return run(args, device)


def run(args, device) -> Dict[str, object]:
    cfg = get_config("gpt-tiny")
    out: Dict[str, object] = {}
    print(f"model: {cfg.name}  layers={cfg.num_layers} d={cfg.d_model} "
          f"params={cfg.total_params() / 1e6:.1f}M")

    # --- 1. the paper's identity: vertical grads == horizontal grads ---
    params, _ = init_train_state(cfg, 0, device=device)
    batch = {k: torch.from_numpy(v).to(device) for k, v in
             make_batch(cfg, 8, 64, seed=1).items()}
    lv, gv = grads_fn(cfg, ScheduleConfig(schedule="vertical"))(params, batch)
    lh, gh = grads_fn(cfg, ScheduleConfig(
        schedule="horizontal", num_microbatches=4))(params, batch)
    err = max((a.float() - b.float()).abs().max().item()
              for a, b in zip(tree.leaves(gv), tree.leaves(gh)))
    print(f"schedule equivalence: loss {float(lv):.4f} vs {float(lh):.4f}, "
          f"max grad diff {err:.2e}")
    out["equivalence"] = {"loss_vertical": float(lv),
                          "loss_horizontal": float(lh), "max_grad_diff": err,
                          "grads": (gv, gh)}

    # --- 2. train a few steps under each schedule ---
    out["trainer"] = {}
    for sched in ("vertical", "horizontal"):
        tr = Trainer(cfg, ScheduleConfig(schedule=sched, num_microbatches=4),
                     AdamConfig(lr=3e-3), device=device)
        rep = tr.run(steps=30, batch_size=8, seq_len=64, log_every=10)
        print(f"{sched:10s}: loss {rep.losses[0]:.3f} -> {rep.losses[-1]:.3f} "
              f"({rep.tokens_per_s:.0f} tok/s)")
        check(rep.losses[-1] < rep.losses[0], "loss must decrease")
        out["trainer"][sched] = rep.losses

    # --- 3. the wave knob on the real offload engine ------------------
    # One compiled plan per W; the measured byte counters show the
    # ckpt-traffic / param-reuse trade-off the §3 analysis predicts
    # (and repro_torch.core.plan.plan_traffic predicts them exactly).
    M = 4

    def engine_step(W, policy, depth=1, alpha=0.0, steps=1):
        with tempfile.TemporaryDirectory() as d:
            eng = OffloadEngine(cfg, OffloadConfig(
                schedule="wave", wave_size=W, num_microbatches=M,
                micro_batch=1, seq_len=64, alpha=alpha,
                ratios=StorageRatios(0.0, 0.0, 0.0),
                activation_policy=policy, prefetch_depth=depth),
                0, d, device=device)
            try:
                tok = make_batch(cfg, M, 64, seed=2)["tokens"]
                loss = [eng.train_step(np.asarray(tok))
                        for _ in range(steps)][-1]
                eng.finish()
                b, pol = dict(eng.meter.bytes), eng.act_policy
                look = eng.metrics_snapshot()["lookahead"]
            finally:
                eng.close()
        return loss, b, pol, look

    print(f"\nwave knob (M={M}; --wave {args.wave}):")
    vertical_cell = None
    out["wave"] = {}
    for W in sorted({1, args.wave, M}):
        loss, b, _, _ = engine_step(W, "recompute")
        if W == M:
            vertical_cell = (loss, b)    # reused by the policy demo
        param = b.get(("param", "cpu->gpu"), 0)
        reread = b.get(("ckpt", "cpu->gpu"), 0) \
            + b.get(("inter_grad", "cpu->gpu"), 0)
        name = {1: "horizontal", M: "vertical"}.get(W, "wave")
        print(f"  W={W} ({name:10s}): loss {loss:.3f}  "
              f"param {param / 1e6:6.1f} MB  ckpt+grad reads "
              f"{reread / 1e6:6.1f} MB")
        out["wave"][W] = {"loss": loss, "bytes": b}

    # --- 4. the activation-policy knob on the same engine -------------
    # "spill" trades backward recompute for an opportunistic SSD stream
    # of each layer's saved tensors; the losses stay bitwise-identical
    # because both policies apply the same saved-tensor backward. The
    # W=M recompute cell above IS the reference — no second run.
    print(f"\nactivation policy (vertical, M={M}; "
          f"--activation-policy {args.activation_policy}):")
    l_re, b_re = vertical_cell
    ckpt_rd_re = b_re.get(("ckpt", "ssd->cpu"), 0)
    print(f"  recompute           : loss {l_re:.6f}  act 0.0 MB  "
          f"ckpt ssd re-reads {ckpt_rd_re / 1e6:5.1f} MB")
    out["policy"] = {"recompute": l_re}
    if args.activation_policy != "recompute":
        l_pol, b_pol, resolved, _ = engine_step(M, args.activation_policy)
        act = sum(v for (c, _), v in b_pol.items() if c == "act")
        ckpt_rd = b_pol.get(("ckpt", "ssd->cpu"), 0)
        print(f"  {args.activation_policy:8s}->{resolved:9s}: "
              f"loss {l_pol:.6f}  act {act / 1e6:.1f} MB  "
              f"ckpt ssd re-reads {ckpt_rd / 1e6:5.1f} MB")
        out["policy"].update({args.activation_policy: l_pol,
                              "resolved": resolved, "act_bytes": act})
        check(l_pol == l_re, "policies must agree bitwise")

    # --- 5. the cross-stream lookahead (adaptive prefetch pipeline) ---
    # PREFETCH / PREFETCH_CKPT / PREFETCH_OPT hints stream every SSD
    # read in `--prefetch-depth` fetches ahead of its consumer (and the
    # α-tail optimizer flush rides the plan epilogue, overlapping the
    # next iteration's first fetches); depth 0 turns all of it off.
    # Byte counters and losses are IDENTICAL — only when bytes move
    # changes, which the hit-rate / stall meters make visible.
    print(f"\ncross-stream lookahead (vertical, alpha=0.3; "
          f"--prefetch-depth {args.prefetch_depth}):")
    results = {}
    for depth in sorted({0, args.prefetch_depth}):
        loss, b, _, look = engine_step(M, "recompute", depth=depth,
                                       alpha=0.3, steps=2)
        results[depth] = (loss, b)
        print(f"  depth {depth}: loss {loss:.6f}  "
              f"hit rate {look['hit_rate']:.2f}  "
              f"stall {look['stall_s']:.3f} s  "
              f"hints skipped {look['hint_skips']}")
    out["lookahead"] = results
    l0, b0 = results[0]
    if args.prefetch_depth != 0:
        ld, bd = results[args.prefetch_depth]
        check(l0 == ld, "lookahead must not change the loss")
        check(b0 == bd, "lookahead must not change a single byte counter")

    # --- 6. span tracing + plan-vs-actual reconciliation --------------
    # trace=True turns the engine's always-compiled-in tracer on: plan
    # ops, the executor's host work (copies, syncs, optimizer waits),
    # per-chunk I/O (queue-wait vs transfer, per path), the host Adam
    # and the hint lifecycle all land on one timeline, exported on
    # torch.profiler's Chrome-trace time base. metrics_snapshot() is
    # the versioned flat contract; obs.reconcile joins it against the
    # plan's byte predictions — exactly.
    if args.trace:
        from repro_torch.obs import reconcile
        print(f"\nobservability (vertical, alpha=0.3, traced; "
              f"--trace {args.trace}):")
        with tempfile.TemporaryDirectory() as d:
            eng = OffloadEngine(cfg, OffloadConfig(
                schedule="vertical", num_microbatches=M,
                micro_batch=1, seq_len=64, alpha=0.3,
                ratios=StorageRatios(0.0, 0.0, 0.0),
                prefetch_depth=args.prefetch_depth or 1, trace=True),
                0, d, device=device)
            try:
                tok = make_batch(cfg, M, 64, seed=2)["tokens"]
                for _ in range(2):
                    eng.train_step(np.asarray(tok))
                eng.finish()
                snap = eng.metrics_snapshot()
                rec = reconcile(eng.plan, snap)
                path = eng.tracer.export_chrome(args.trace)
            finally:
                eng.close()
        print(f"  {len(eng.tracer)} spans -> {path} "
              "(open in ui.perfetto.dev; a torch.profiler "
              "export_chrome_trace of the same window lines up beside it)")
        print(rec.format())
        out["reconcile_ok"] = rec.ok
        check(rec.ok, "plan-vs-actual byte reconciliation must be exact")

    # --- 7. the online autotuner (measure -> re-solve -> swap) --------
    # The controller measures each window's live route rates from the
    # chunk spans, re-runs Algorithm 1 per candidate plan under that
    # machine, and hot-swaps the engine between iterations when the
    # predicted win clears hysteresis. The demo scripts a device
    # slowdown into the snapshot feed (a 1 MB/s SSD on a compute-bound
    # box — the scenario where the lookahead plan genuinely wins) so
    # the retune is deterministic; on real drifting hardware the same
    # loop runs off the unscripted `metrics_snapshot()`.
    if args.autotune:
        print("\nonline autotuner (vertical, alpha=0.3, depth 0, "
              "scripted SSD drift; --autotune):")
        with tempfile.TemporaryDirectory() as d:
            eng = OffloadEngine(cfg, OffloadConfig(
                schedule="vertical", num_microbatches=M,
                micro_batch=1, seq_len=64, alpha=0.3,
                ratios=StorageRatios(0.0, 0.0, 0.0),
                prefetch_depth=0), 0, d, device=device)
            try:
                real = eng.metrics_snapshot

                def drifted():
                    snap = real()
                    for r in snap["trace"]["routes"].values():
                        if r.get("bytes"):
                            r["busy_wall_s"] = r["bytes"] / 1e6
                            r["rate_bps"] = 1e6
                    return snap

                eng.metrics_snapshot = drifted
                ctl = AutotuneController(eng, AutotuneConfig(
                    interval=1, hysteresis=0.0, cooldown=1,
                    prefetch_depths=(0, 2),
                    machine=MachineParams(name="drift", gpu_flops=1e8,
                                          ssd_read_bw=1e6, ssd_write_bw=1e6,
                                          cpu_mem=2e7)))
                tok = make_batch(cfg, M, 64, seed=2)["tokens"]
                for _ in range(3):
                    eng.train_step(np.asarray(tok))
                    dec = ctl.post_step()        # interval=1: every step
                    reason = dec.get("reason", "")
                    print(f"  window {dec['window']}: {dec['action']:8s} "
                          f"{reason}")
                depth = eng.ocfg.resolved_prefetch_depth()
                print(f"  retunes {ctl.retunes}  prefetch depth 0 -> "
                      f"{depth}")
                out["autotune"] = {"retunes": ctl.retunes, "depth": depth}
                check(ctl.retunes >= 1 and depth == 2,
                      "the drifted LP must pick the lookahead plan")
                eng.finish()
            finally:
                eng.close()

    # --- 8. dynamic per-path placement on a heterogeneous device ------
    # Two SSD paths paced 4:1. Static striping alternates chunks
    # i % P, so every transfer waits on the slow path (throughput ->
    # 2x the slow cap); the "backlog" policy asks the engine's
    # idle-level signal per chunk and drains placement toward the fast
    # path (-> sum of caps). The tracer's per-path achieved rates make
    # the split visible, and the same rates drive the autotuner's
    # path_policy candidate axis.
    if args.hetero_paths:
        import time as _time
        caps = (100e6, 25e6)
        print(f"\nheterogeneous paths (vertical, alpha=0.75, 2 paths "
              f"paced {caps[0] / 1e6:.0f}/{caps[1] / 1e6:.0f} MB/s; "
              "--hetero-paths):")

        def hetero_engine(d, policy):
            return OffloadEngine(cfg, OffloadConfig(
                schedule="vertical", num_microbatches=M,
                micro_batch=1, seq_len=64, alpha=0.75,
                ratios=StorageRatios(0.0, 0.0, 0.0),
                prefetch_depth=2, trace=True,
                io=IOConfig(paths=[f"{d}/p0", f"{d}/p1"],
                            chunk_bytes=256 << 10,
                            path_bandwidth=caps, path_policy=policy)),
                0, d, device=device)

        tok = np.asarray(make_batch(cfg, M, 64, seed=2)["tokens"])
        losses, rates = {}, {}
        for policy in ("static", "backlog"):
            with tempfile.TemporaryDirectory() as d:
                eng = hetero_engine(d, policy)
                try:
                    eng.train_step(tok)              # warm-up (ssd cold)
                    t0 = _time.perf_counter()
                    losses[policy] = eng.train_step(tok)
                    eng.finish()
                    dt = _time.perf_counter() - t0
                    pp = eng.metrics_snapshot()["trace"]["routes"][
                        "ssd->cpu"]["per_path"]
                finally:
                    eng.close()
            rates[policy] = dt
            split = "  ".join(
                f"path{p}: {pp[p]['rate_bps'] / 1e6:5.1f} MB/s "
                f"({pp[p]['bytes'] / 1e6:.0f} MB)"
                for p in sorted(pp, key=int))
            print(f"  {policy:8s}: {M * 64 / dt:6.0f} tok/s  "
                  f"ssd reads {split}")
        check(losses["static"] == losses["backlog"],
              "placement must never change what the model computes")
        print(f"  backlog speedup {rates['static'] / rates['backlog']:.2f}x "
              "(placement is byte- and loss-neutral, only WHERE moves)")

        # the autotuner closes the same loop online: measure the static
        # run's per-path rates, price static (P x min) vs backlog
        # (sum of rates) through Algorithm 1, and actuate the flip.
        # The base machine pins cpu_mem below the model's footprint so
        # the LP must place state on the SSD tier (gpt-tiny would fit
        # in DRAM and the path rates would never enter the solve); the
        # measured per-path rates overlay it via machine_from_snapshot.
        # error_gate is relaxed: one cold window on a noisy shared host
        # shouldn't block the demo's retune.
        with tempfile.TemporaryDirectory() as d:
            eng = hetero_engine(d, "static")
            try:
                ctl = AutotuneController(eng, AutotuneConfig(
                    interval=1, hysteresis=0.0, cooldown=1, error_gate=2.0,
                    path_policies=("static", "backlog"),
                    machine=MachineParams(name="hetero", cpu_mem=2e7)))
                for _ in range(2):
                    eng.train_step(tok)
                    dec = ctl.post_step()
                    print(f"  window {dec['window']}: {dec['action']:8s} "
                          f"{dec.get('changes', '')} "
                          f"{dec.get('reason', '')}")
                    if dec["action"] == "retune":
                        break
                policy_now = eng.ioe.path_policy
                print(f"  path_policy static -> {policy_now}")
                out["hetero"] = {"losses": losses, "seconds": rates,
                                 "policy": policy_now}
                check(policy_now == "backlog",
                      "the live per-path rates must price backlog as the "
                      "win")
                eng.finish()
            finally:
                eng.close()

    # --- 9. the resilient I/O fabric (--chaos) ------------------------
    # ChaosFiles sits at the pwrite/pread layer of the stripe backend
    # and injects seeded transient faults into REAL chunk ops. With
    # per-chunk CRC32C (IOConfig.integrity) and bounded in-place
    # retries the trajectory stays bitwise identical to a fault-free
    # twin; a crash-consistent checkpoint — written through the same
    # faulty device — then round trips the whole optimizer state into
    # a fresh engine and training resumes bitwise.
    if args.chaos:
        from repro_torch.io.chaos import ChaosSpec, install_chaos
        print("\nresilient I/O (vertical, M=4, 5% transient fault "
              "rate; --chaos):")

        def resilient_engine(d):
            return OffloadEngine(cfg, OffloadConfig(
                schedule="vertical", num_microbatches=M,
                micro_batch=1, seq_len=64,
                ratios=StorageRatios(0.0, 0.0, 0.0),
                io=IOConfig(retries=5, integrity=True)), 0, d,
                device=device)

        tok = np.asarray(make_batch(cfg, M, 64, seed=2)["tokens"])
        with tempfile.TemporaryDirectory() as d_cl, \
                tempfile.TemporaryDirectory() as d_ch, \
                tempfile.TemporaryDirectory() as d_new, \
                tempfile.TemporaryDirectory() as d_ck:
            e_cl, e_ch = resilient_engine(d_cl), resilient_engine(d_ch)
            try:
                chaos = install_chaos(e_ch.ssd, ChaosSpec(
                    error_rate=0.05, latency_rate=0.05, latency_s=0.0005,
                    seed=11))
                for _ in range(2):
                    l_cl, l_ch = e_cl.train_step(tok), e_ch.train_step(tok)
                    check(l_cl == l_ch,
                          "absorbed faults must be invisible to the math")
                snap = e_ch.ioe.metrics_snapshot()
                print(f"  2 steps under chaos: loss {l_ch:.6f} == clean "
                      f"twin ({sum(chaos.injected.values())} faults "
                      f"injected, {snap['chunk_retries']} chunk retries)")

                # checkpoint through the faulty device, continue one step
                # on the original engine to pin the reference trajectory,
                # then restore into a FRESH engine and catch up.
                e_ch.save_checkpoint(d_ck)
                l_next = e_ch.train_step(tok)
                for e in (e_cl, e_ch):
                    e.finish()
            finally:
                e_cl.close()
                e_ch.close()
            e_new = resilient_engine(d_new)
            try:
                step0 = e_new.restore_checkpoint(d_ck)
                l_resume = e_new.train_step(tok)
                print(f"  checkpoint @ step {step0} -> fresh engine: "
                      f"resumed loss {l_resume:.6f} "
                      f"{'==' if l_resume == l_next else '!='} continued "
                      "trajectory")
                out["chaos"] = {"faults": sum(chaos.injected.values()),
                                "resumed": l_resume, "continued": l_next}
                check(l_resume == l_next,
                      "restore must continue the trajectory bitwise")
                e_new.finish()
            finally:
                e_new.close()
    print("OK")
    return out


if __name__ == "__main__":
    main()
