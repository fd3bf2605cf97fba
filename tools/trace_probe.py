#!/usr/bin/env python3
"""What the engine's span tracer costs, and how its clock lines up with
``torch.profiler``'s, at a benchmark cell's size on the card.

Builds the cell's engine as the benchmark does (``perfbench/harness``:
the configuration, the seed's weights and rows), runs the mix's checked
steps as warm-up, then, for each of ``--seeds`` seeds, one step with the
tracer off and one with it on, in turns (the order flips from seed to
seed; the two share the seed's rows). Each step ends with ``finish()``
and a device sync. Per step it reports tokens/s, the spans recorded, the
ring's dropped count, ``eng.host_syncs``, the host Adam's busy seconds
and elements from the optimizer coordinator's counters beside the
benchmark's own ``AdamMeter`` on the same calls, and the pinned pool's
counters (``pool_slots``, ``pool_pinned_bytes``, ``pool_copies``,
``pool_fallbacks``).

Last, one traced step inside the benchmark's device trace
(``harness.devtrace.DeviceTrace``, its window mark and its idle gaps):
the gap between the harness's placement of a host stamp (the mark's
profiler start plus ``perf_counter`` seconds since) and the tracer's own
mapping (``Tracer.to_unix_ns``) at the window's start and end, and, per
span name on the executor's host track (copies also by meter category)
and for ``adam.update``, the count, seconds, bytes and the seconds of it
in which the card ran nothing.

It measures the card and exits 2 without one; ``--smoke`` checks the
script at SMOKE size, on the CPU where there is no card, without the
device-trace step.

    python3 tools/trace_probe.py --workload sc2-7b.train.s2k --seeds 3 \\
        [--seed0 7] [--out probe_sc2.json] [--smoke]

Prints one JSON object (also written to ``--out``).
"""
from __future__ import annotations

import argparse
import bisect
import json
import os
import shutil
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for _p in (os.path.join(ROOT, "perfbench"), os.path.join(ROOT, "src")):
    if _p not in sys.path:
        sys.path.insert(0, _p)


def _step(eng, tokens, traced, adam, sync):
    """One step and its ``finish()``, tracer on or off; its numbers."""
    tr = eng.tracer
    eng.reset_stats()
    adam.reset()
    tr.clear()
    if traced:
        tr.enable()
    sync()
    t0 = time.perf_counter()
    eng.train_step(tokens)
    eng.finish()
    sync()
    secs = time.perf_counter() - t0
    tr.disable()
    return {"traced": traced, "seconds": secs,
            "tokens_per_s": tokens.size / secs, "spans": len(tr),
            "dropped": tr.dropped, "host_syncs": eng.host_syncs,
            "adam_busy_s": eng.opt_c.adam_busy_s,
            "adam_params": eng.opt_c.adam_params,
            "adam_calls": eng.opt_c.adam_calls,
            "meter_adam_busy_s": adam.busy_s,
            "meter_adam_params": adam.params,
            "pool": {k: v for k, v in
                     eng.metrics_snapshot()["counters"].items()
                     if k.startswith("pool_")}}


def _idle_between(gaps):
    """``idle(lo, hi)``: seconds of the disjoint ``gaps`` inside
    ``[lo, hi]``."""
    gaps = sorted(gaps)
    starts = [a for a, _ in gaps]
    cum = [0.0]
    for a, b in gaps:
        cum.append(cum[-1] + b - a)

    def before(x):
        i = bisect.bisect_right(starts, x)
        if i == 0:
            return 0.0
        a, b = gaps[i - 1]
        return cum[i - 1] + min(x, b) - a
    return lambda lo, hi: before(hi) - before(lo)


def _clock(eng, tokens, sync):
    """One traced step inside the benchmark's device trace
    (``harness.devtrace.DeviceTrace``): the tracer's mapping against the
    harness's anchor at the window's start and end, and the executor's
    host work with the card's idle seconds inside it."""
    import torch

    from harness.devtrace import WINDOW_MARK, DeviceTrace
    from repro_torch.obs.tracer import HOST_TRACK
    tr = eng.tracer
    tr.clear()
    tr.enable()
    trace = DeviceTrace()
    trace.start()
    prof = trace._prof
    eng.train_step(tokens)
    eng.finish()
    sync()
    trace.stop()
    tr.disable()
    t0, t1 = trace._t0, trace._t1
    mark = next(e for e in prof.profiler.kineto_results.events()
                if e.name() == WINDOW_MARK
                and e.device_type() != torch.autograd.DeviceType.CUDA)
    start = mark.start_ns()
    end = start + mark.duration_ns()
    harness_end = start + int((t1 - t0) * 1e9)
    idle = _idle_between(trace.gaps)
    host = {}
    for track, name, cat, a, b, args in tr.spans():
        if b is None or (track != HOST_TRACK and name != "adam.update"):
            continue
        key = name if cat != "copy" or name == "host.stage" else \
            f"{name}:{args['category']}"
        rec = host.setdefault(key, {"n": 0, "seconds": 0.0, "nbytes": 0,
                                    "card_idle_s": 0.0})
        rec["n"] += 1
        rec["seconds"] += b - a
        rec["nbytes"] += int(args.get("nbytes", 0))
        rec["card_idle_s"] += idle(a, b)
    return {"window_s": t1 - t0, "busy_s": trace.busy_s,
            "start_gap_ns": tr.to_unix_ns(t0) - start,
            "end_gap_ns": tr.to_unix_ns(t1) - harness_end,
            "mark_end_vs_tracer_ns": tr.to_unix_ns(t1) - end,
            "harness_end_vs_mark_end_ns": harness_end - end,
            "clock": tr.clock(), "spans": len(tr), "dropped": tr.dropped,
            "host": host}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=3)
    ap.add_argument("--seed0", type=int, default=7)
    ap.add_argument("--out", default="")
    ap.add_argument("--smoke", action="store_true",
                    help="the configuration's SMOKE widths, 4 micro-batches "
                         "of 64 tokens, on the CPU if there is no card, "
                         "without the device-trace step (a check of the "
                         "script)")
    args = ap.parse_args(argv)

    import torch
    if not (args.smoke or torch.cuda.is_available()):
        print("trace_probe: no CUDA device; it measures the card only "
              "(--smoke checks the script on the CPU)", file=sys.stderr)
        return 2

    from harness import program, spec, traffic
    from harness.weights import make_weights
    bench = spec.benchmark()
    cell = spec.cell(bench, args.workload)
    cfg = spec.config(bench, cell["config"])
    mix = spec.traffic(cell["traffic"])
    if args.smoke:
        from repro_torch.configs import get_smoke
        sm = get_smoke(cfg["registry"])
        cfg.update({k: getattr(sm, k) for k in (
            "d_model", "num_heads", "num_kv_heads", "head_dim", "d_ff",
            "vocab_size")})
        mix.update(micro_batches=4, seq_len=64)
    train = cfg["train"]
    device = torch.device("cuda" if torch.cuda.is_available() else "cpu")

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    vocab = int(cfg["vocab_size"])
    root = tempfile.mkdtemp(prefix="trace-probe-")
    dirs = [os.path.join(root, f"path{i}")
            for i in range(int(train["engine"]["ssd_paths"]))]
    for d in dirs:
        os.makedirs(d)
    out = {"workload": args.workload, "device": str(device),
           "torch": torch.__version__, "steps": []}
    if device.type == "cuda":
        out["card"] = torch.cuda.get_device_name(device)
    eng = None
    try:
        t_setup = time.perf_counter()
        weights = make_weights(cfg, args.seed0, getattr(
            torch, train["param_dtype"]), device)
        eng, _ = program.build_engine(cfg, train, mix, weights, dirs, device)
        del weights
        adam = program.AdamMeter(eng.opt_c.adam)
        for k in range(1, int(mix["checked_steps"]) + 1):
            eng.train_step(traffic.step_tokens(mix, vocab, args.seed0, k))
        eng.finish()
        sync()
        out["setup_s"] = time.perf_counter() - t_setup
        for i in range(args.seeds):
            seed = args.seed0 + 1 + i
            tokens = traffic.step_tokens(mix, vocab, seed, 1)
            for traced in ((False, True) if i % 2 == 0 else (True, False)):
                rec = _step(eng, tokens, traced, adam, sync)
                rec["seed"] = seed
                out["steps"].append(rec)
                print(json.dumps(rec), file=sys.stderr, flush=True)
        if device.type == "cuda":
            out["clock"] = _clock(eng, traffic.step_tokens(
                mix, vocab, args.seed0 + args.seeds + 1, 1), sync)
    finally:
        if eng is not None:
            eng.close()
        shutil.rmtree(root, ignore_errors=True)
    on = [s["tokens_per_s"] for s in out["steps"] if s["traced"]]
    off = [s["tokens_per_s"] for s in out["steps"] if not s["traced"]]
    out["traced_over_untraced"] = [a / b for a, b in zip(on, off)]
    line = json.dumps(out)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line)
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
