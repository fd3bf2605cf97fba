#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one CUDA card.

Phases, each of which fails the run (non-zero exit, no result line):

1. device — the card's name and power limit; TF32 off for f32 products.
2. build — every kernel of the port from ``src/repro_torch/csrc`` (one
   ``nvcc`` per source, started together), with the ``-Xptxas -v`` report.
3. kernels — each kernel against its plain PyTorch version on the card at
   the shapes the serving path gives it, within the stated tolerance, and
   timed beside its bound, its plain version and one PyTorch library call.
4. serve — ``ServeEngine`` at GPT-65B full width (depth cut to
   ``SERVE_LAYERS``), bf16 params tiered across host and SSD, three requests
   (2048/1024/512-token prompts, 16 new tokens each) with a mid-run
   preempt. Checks: the three-way KV byte invariant (plan == meters ==
   closed form) exactly, every request's tokens equal to the port's
   in-memory B=1 reference decode, K1 launches == prefills x layers, and a
   small f32 model on the card agreeing with the same model on the CPU.

Prints every measurement (a ``serve stats`` JSON line, a
``{"kernels": [...]}`` line with each shape's numbers), the
``nvidia-smi`` name/power-limit line, and last
``{"ok": true, "device": {...}}``.

    python3 chip_smoke.py                # what a check runs: all phases
    python3 chip_smoke.py --phases kernels
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

PEAK_BYTES_S = 3.35e12                  # H100 SXM HBM3
PEAK_FLOPS = {"bfloat16": 989e12,       # dense tensor-core rate
              "float32": 67e12}         # CUDA-core f32 rate
TOL = {"bfloat16": 2e-2, "float32": 1e-5}   # as tests/test_kernels.py
# ||out - ref|| / ||ref|| bound, beside the elementwise TOL: late causal rows
# average over many keys, so |out| there is small and TOL alone would pass
# a P.V error confined to them
REL_TOL = 1e-2
# GPT-65B keeps its full width; its 80 layers are cut to 2 so that the
# per-step SSD->host->device parameter stream (~1.6 GB per layer) fits the
# run's time limit
SERVE_LAYERS = 2

# (name, B, Hq, Hk, S, hd, dtype, causal, window, q0)
K1_SHAPES = [
    ("gpt-65b prefill S=2048", 1, 64, 64, 2048, 128, "bfloat16", True, None, 0),
    ("gpt-65b prefill S=1024", 1, 64, 64, 1024, 128, "bfloat16", True, None, 0),
    ("gpt-65b prefill S=512", 1, 64, 64, 512, 128, "bfloat16", True, None, 0),
    ("qwen3-4b gqa S=1024", 1, 32, 8, 1024, 128, "bfloat16", True, None, 0),
    ("small f32 non-causal", 2, 4, 4, 256, 64, "float32", False, None, 0),
    ("small f32 gqa window q0", 1, 8, 2, 200, 64, "float32", True, 48, 16),
]
HEADLINE = "gpt-65b prefill S=2048"


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else \
        f"nvidia-smi failed: {out.stderr.strip()}"


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def k1_work(B, Hq, Hk, S, hd, dtype, causal, window, q0):
    """(bytes, flops) K1 needs on these inputs: q, k, v read once, out and
    lse written once; 4*hd FLOP (QK^T and PV) per admitted (query, key)
    pair, counted for this mask."""
    item = 2 if dtype == "bfloat16" else 4
    nbytes = item * hd * S * (2 * B * Hq + 2 * B * Hk) + 4 * B * Hq * S
    pairs = 0
    for i in range(S):
        p = q0 + i
        lo = 0 if window is None else max(0, p - window + 1)
        hi = min(S - 1, p) if causal else S - 1
        pairs += max(0, hi - lo + 1)
    return nbytes, 4 * hd * pairs * B * Hq


def phase_kernels(torch, fa, report):
    import torch.nn.functional as F
    rows = []
    for (name, B, Hq, Hk, S, hd, dts, causal, window, q0) in K1_SHAPES:
        dt = getattr(torch, dts)
        g = torch.Generator(device="cuda").manual_seed(len(rows))
        q = torch.randn(B, Hq, S, hd, device="cuda", generator=g).to(dt)
        k = torch.randn(B, Hk, S, hd, device="cuda", generator=g).to(dt)
        v = torch.randn(B, Hk, S, hd, device="cuda", generator=g).to(dt)
        kw = dict(causal=causal, window=window, q0=q0)
        out, lse = fa.flash_attention_fwd(q, k, v, **kw)
        torch.cuda.synchronize()
        ref, ref_lse = fa.flash_attention_plain(q, k, v, **kw)
        diff = (out.float() - ref.float()).abs()
        err = diff.max().item()
        rel_err = (diff.norm() / ref.float().norm()).item()
        lse_err = (lse - ref_lse).abs().max().item()
        tol = TOL[dts]          # elementwise atol = rtol = tol
        ok = (bool(torch.isfinite(out.float()).all())
              and bool((diff <= tol + tol * ref.float().abs()).all())
              and rel_err <= REL_TOL and lse_err <= 1e-3)
        reps = 20 if S >= 1024 else 50
        ms = cuda_ms(lambda: fa.flash_attention_fwd(q, k, v, **kw), reps)
        plain_ms = cuda_ms(lambda: fa.flash_attention_plain(q, k, v, **kw),
                           max(3, reps // 5), warmup=1)
        lib_ms = None
        if window is None and q0 == 0:
            G = Hq // Hk
            kr = k.repeat_interleave(G, dim=1)
            vr = v.repeat_interleave(G, dim=1)
            lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
                q, kr, vr, is_causal=causal), reps)
        nbytes, flops = k1_work(B, Hq, Hk, S, hd, dts, causal, window, q0)
        t_bytes = nbytes / PEAK_BYTES_S * 1e3
        t_ops = flops / PEAK_FLOPS[dts] * 1e3
        row = {"shape": name, "q": [B, Hq, S, hd], "kv_heads": Hk,
               "dtype": dts, "causal": causal, "window": window, "q0": q0,
               "max_abs_err": err, "rel_err": rel_err,
               "lse_max_abs_err": lse_err, "tol": TOL[dts],
               "rel_tol": REL_TOL, "ok": ok, "ms": ms, "plain_ms": plain_ms,
               "library_ms": lib_ms, "bound_ms": max(t_bytes, t_ops),
               "bound_by": "operations" if t_ops >= t_bytes else "bytes",
               "tflops": flops / (ms * 1e-3) / 1e12}
        rows.append(row)
        report(f"K1 {name}: err {err:.3e} (tol {TOL[dts]}) rel_err "
               f"{rel_err:.3e} (tol {REL_TOL}) lse_err "
               f"{lse_err:.3e} | kernel {ms:.4f} ms ({row['tflops']:.2f} "
               f"TFLOP/s) plain {plain_ms:.4f} ms sdpa {lib_ms} ms bound "
               f"{row['bound_ms']:.4f} ms ({row['bound_by']}) -> "
               f"{'OK' if ok else 'FAIL'}")
        del q, k, v, out, lse, ref, ref_lse
    torch.cuda.empty_cache()
    return rows


def reference_decode(torch, mdl, params, cfg, prompt, gen, max_len):
    """The port's in-memory B=1 reference on the card: prefill + greedy
    decode. Returns (tokens, prefill seconds on the host clock,
    synchronised)."""
    caches = mdl.init_caches(cfg, 1, max_len, dtype=torch.bfloat16)
    tokens = torch.tensor([prompt], device="cuda")
    t0 = time.perf_counter()
    logits, caches = mdl.prefill(params, cfg, {"tokens": tokens}, caches)
    toks = [int(torch.argmax(logits[0]))]
    prefill_s = time.perf_counter() - t0
    for i in range(gen - 1):
        logits, caches = mdl.decode_step(
            params, cfg, torch.tensor([[toks[-1]]], device="cuda"),
            len(prompt) + i, caches)
        toks.append(int(torch.argmax(logits[0])))
    return toks, prefill_s


def check_three_way(eng):
    from repro_torch.core.traffic import kv_traffic
    measured = {k: int(v) for k, v in eng.meter.bytes.items()}
    predicted = {k: int(v) for k, v in eng.predicted_traffic.items()}
    errs = [f"{k}: measured {measured.get(k, 0)} != plan "
            f"{predicted.get(k, 0)}" for k in set(measured) | set(predicted)
            if measured.get(k, 0) != predicted.get(k, 0)]
    kt = kv_traffic(eng.kv_unit_nbytes, eng.scfg.kv_block_bytes,
                    eng.scfg.kv_x_host, eng.kv_spills, eng.kv_fetches)
    for route, want in (("gpu->cpu", kt.spill), ("cpu->ssd", kt.ssd_spill),
                        ("cpu->gpu", kt.fetch), ("ssd->cpu", kt.ssd_fetch)):
        if measured.get(("kv", route), 0) != want:
            errs.append(f"kv {route}: measured "
                        f"{measured.get(('kv', route), 0)} != closed form "
                        f"{want}")
    return errs, measured


def phase_serve(torch, fa, report, cfg, prompt_lens, gen: int,
                workroot: str):
    """Three requests through ``ServeEngine`` on the card in bf16, with a
    preempt after step 5; returns (failures, stats)."""
    from repro_torch.data import SyntheticLM
    from repro_torch.io import IOConfig
    from repro_torch.models import model as mdl
    from repro_torch.serve import ServeConfig, ServeEngine

    max_len = max(prompt_lens) + gen
    data = SyntheticLM(cfg.vocab_size, seed=0)
    prompts = [[int(t) for t in data.batch(1, n)[0]] for n in prompt_lens]
    params = mdl.init_params(cfg, 0, dtype=torch.bfloat16)
    workdir = tempfile.mkdtemp(prefix="serve-", dir=workroot)
    try:
        # budget for all three requests; half of the KV blocks and half
        # of each unit's param bytes live on the SSD tier
        template = mdl.init_caches(cfg, 1, max_len, dtype=torch.bfloat16,
                                   device="meta")
        unit = mdl.cache_unit_nbytes(cfg, template)
        bb = 1 << 20
        budget = 3 * sum(-(-nb // bb) for nb in unit) * bb
        scfg = ServeConfig(max_len=max_len, kv_block_bytes=bb,
                           kv_budget_bytes=budget, kv_x_host=0.5,
                           param_x_host=0.5, prefetch_depth=1,
                           param_dtype="bfloat16",
                           io=IOConfig(paths=[workdir], chunk_bytes=8 << 20))
        t0 = time.perf_counter()
        eng = ServeEngine(cfg, scfg, 0, workdir, params=params)
        report(f"engine built in {time.perf_counter() - t0:.2f} s: "
               f"{len(eng.units)} units, param blob "
               f"{sum(eng.param_unit_nbytes) / 1e9:.3f} GB/step, KV "
               f"{sum(eng.kv_unit_nbytes) / 1e6:.1f} MB/request")
        rids = [eng.submit(p, gen) for p in prompts]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fa.launches = 0                      # main path starts here
        prefills, steps, preempted_rid = 0, 0, None
        t_run = time.perf_counter()
        step_s = []
        while eng.pending():
            ts = time.perf_counter()
            dec = eng.step()
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - ts)
            prefills += len(dec["admitted"])
            steps += 1
            if steps == 5 and preempted_rid is None:
                preempted_rid = rids[1]
                eng.preempt(preempted_rid)
            if steps > 200:
                raise RuntimeError("serve loop did not converge")
        run_s = time.perf_counter() - t_run
        k1_launches = fa.launches            # main path ends here
        peak = torch.cuda.max_memory_allocated()
        eng.close()          # settles the async SSD spills of the last step
        snap = eng.metrics_snapshot()
        errs, measured = check_three_way(eng)
        results = {r: eng.result(r) for r in rids}
        evictions = eng.requests[preempted_rid].evictions
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    failures = list(errs)
    if evictions < 1 or snap["kv"]["preempted"] < 1:
        failures.append("the preempt did not happen")
    if k1_launches != prefills * cfg.num_layers:
        failures.append(f"K1 launches {k1_launches} != prefills {prefills} "
                        f"x layers {cfg.num_layers}")
    ref_prefill_ms = {}
    for rid, p in zip(rids, prompts):
        want, t_pre = reference_decode(torch, mdl, params, cfg, p, gen,
                                       max_len)
        ref_prefill_ms[len(p)] = 1e3 * t_pre
        if results[rid] != want:
            failures.append(f"request {rid} tokens {results[rid]} != "
                            f"in-memory reference {want}")
        report(f"request {rid} (prompt {len(p)}): {results[rid]} "
               f"{'== reference' if results[rid] == want else '!= ' + str(want)}")
    del params
    torch.cuda.empty_cache()
    pt = snap["phase_time"]
    stats = {
        "steps": steps, "run_s": run_s, "step_s": step_s,
        "prefills": prefills, "k1_launches": k1_launches,
        "prefill_ms_mean": 1e3 * pt.get("prefill", 0.0) / max(prefills, 1),
        "in_memory_prefill_ms": ref_prefill_ms,
        "op_seconds": snap["op_seconds"],
        "compute_share": (pt.get("prefill", 0.0) + pt.get("decode", 0.0))
        / run_s,
        "decode_tokens": snap["tokens_decoded"],
        "decode_tokens_per_s": snap["tokens_decoded"] / pt["decode"]
        if pt.get("decode") else 0.0,
        "end_to_end_tokens_per_s":
            (snap["tokens_decoded"] + prefills) / run_s,
        "kv_hit_rate": snap["kv"]["hit_rate"],
        "max_memory_allocated": peak,
        "traffic": {f"{c}:{r}": v for (c, r), v in sorted(measured.items())},
        "lookahead": snap["lookahead"],
    }
    return failures, stats


def phase_small_parity(torch, report):
    """gpt-tiny in f32: the engine on the card (K1 in prefill) against the
    same model on the CPU (plain attention), logits within 1e-3."""
    import numpy as np

    from repro_torch import tree
    from repro_torch.configs import get_config
    from repro_torch.models import model as mdl
    cfg = get_config("gpt-tiny")
    params = mdl.init_params(cfg, 1, dtype=torch.float32, device="cpu")
    rng = np.random.default_rng(0)
    prompt = [int(t) for t in rng.integers(0, cfg.vocab_size, 64)]
    outs = {}
    for dev in ("cpu", "cuda"):
        p = tree.tree_map(lambda a: a.to(dev), params)
        caches = mdl.init_caches(cfg, 1, 72, dtype=torch.float32, device=dev)
        logits, caches = mdl.prefill(
            p, cfg, {"tokens": torch.tensor([prompt], device=dev)}, caches)
        seq = [logits.cpu()]
        tok = int(torch.argmax(logits[0]))
        for i in range(4):
            logits, caches = mdl.decode_step(
                p, cfg, torch.tensor([[tok]], device=dev), 64 + i, caches)
            seq.append(logits.cpu())
            tok = int(torch.argmax(logits[0]))
        outs[dev] = torch.stack(seq)
    worst = (outs["cpu"] - outs["cuda"]).abs().max().item()
    ok = worst <= 1e-3 and bool(torch.isfinite(outs["cuda"]).all())
    report(f"gpt-tiny f32 card vs CPU logits: max abs diff {worst:.3e} "
           f"(tol 1e-3: f32 sums in another order on each device) -> "
           f"{'OK' if ok else 'FAIL'}")
    return [] if ok else [f"gpt-tiny card/CPU logits differ by {worst}"]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default="kernels,serve",
                    help="comma list of: kernels, serve")
    args = ap.parse_args()
    phases = set(args.phases.split(","))

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    try:
        from repro_torch.configs import get_config
        from repro_torch.kernels import _build
        from repro_torch.kernels import flash_attention as fa
    except ImportError as e:
        print(f"chip_smoke: the port is not importable: {e}",
              file=sys.stderr)
        return 1

    def report(msg):
        print(msg, flush=True)

    # 1. device
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    report(f"device: {kind} x{torch.cuda.device_count()} | nvidia-smi: {smi}"
           f" | torch {torch.__version__} cuda {torch.version.cuda}")

    # 2. build
    t0 = time.perf_counter()
    logs = _build.build_all()
    report(f"built {sorted(logs)} in {time.perf_counter() - t0:.1f} s")
    for name in logs:
        for ln in _build.ptxas_report(name):
            report(f"  {name}: {ln.strip()}")

    failures = []
    rows = []
    # 3. kernels
    if "kernels" in phases:
        rows = phase_kernels(torch, fa, report)
        failures += [f"K1 {r['shape']}: err {r['max_abs_err']} rel_err "
                     f"{r['rel_err']} lse_err {r['lse_max_abs_err']}"
                     for r in rows if not r["ok"]]
    # 4. serve
    stats = {}
    if "serve" in phases:
        workroot = os.path.join(ROOT, "_work")
        os.makedirs(workroot, exist_ok=True)
        full = get_config("gpt-65b")
        cfg = dataclasses.replace(full, num_layers=SERVE_LAYERS)
        report(f"serve model: {full.name} at full width (d_model "
               f"{cfg.d_model}, {cfg.num_heads} heads x {cfg.head_dim}, d_ff "
               f"{cfg.d_ff}, vocab {cfg.vocab_size} -> {cfg.padded_vocab}), "
               f"depth cut {full.num_layers} -> {cfg.num_layers} layers, "
               f"bf16 params")
        f, stats = phase_serve(torch, fa, report, cfg, (2048, 1024, 512), 16,
                               workroot)
        failures += f
        failures += phase_small_parity(torch, report)
        report(f"serve ({smi}): {stats['prefills']} prefills, prefill "
               f"{stats['prefill_ms_mean']:.2f} ms/request (mean), decode "
               f"{stats['decode_tokens_per_s']:.3f} tokens/s "
               f"({stats['decode_tokens']} tokens), end to end "
               f"{stats['end_to_end_tokens_per_s']:.3f} tokens/s over "
               f"{stats['steps']} steps in {stats['run_s']:.2f} s, KV hit "
               f"rate {stats['kv_hit_rate']:.3f}, max_memory_allocated "
               f"{stats['max_memory_allocated'] / 2**30:.2f} GiB, compute "
               f"phases {100 * stats['compute_share']:.2f} % of the run")
        report("serve op seconds: " + json.dumps(stats["op_seconds"]))
        report("in-memory prefill ms by prompt length: "
               + json.dumps(stats["in_memory_prefill_ms"]))
        report("serve stats: " + json.dumps(stats))

    if failures:
        for msg in failures:
            print(f"FAIL: {msg}", file=sys.stderr)
        return 1

    head = next((r for r in rows if r["shape"] == HEADLINE), None)
    k1 = {"name": "K1 flash_attention_fwd", "route": "cuda",
          "source": "src/repro_torch/csrc/flash_attention_fwd.cu",
          "replaces": "src/repro/kernels/flash_attention.py:27",
          "launches": stats.get("k1_launches", 0),
          "max_abs_err": max((r["max_abs_err"] for r in rows), default=None),
          "ms": head["ms"] if head else None,
          "plain_ms": head["plain_ms"] if head else None,
          "bound_ms": head["bound_ms"] if head else None,
          "bound_by": head["bound_by"] if head else None,
          "library_ms": head["library_ms"] if head else None,
          "at": HEADLINE, "card": smi, "shapes": rows}
    print(json.dumps({"kernels": [k1]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
