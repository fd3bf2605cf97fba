#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one CUDA card.

Phases, each of which fails the run (non-zero exit, no result line):

1. device — the card's name and power limit; TF32 off for f32 products.
2. build — every kernel of the port from ``src/repro_torch/csrc`` (one
   ``nvcc`` per source, started together), with the ``-Xptxas -v`` report.
3. kernels — each kernel against its plain PyTorch version on the card at
   the shapes the serving and training paths give it, within the stated
   tolerance, and timed beside its bound, its plain version and one
   PyTorch library call: K1 forward, K1 backward (also run twice and
   required bit-identical; hd 32, 64 and 128), K2 fused Adam (also the
   two-stage ``[0,k)`` + ``[k,n)`` launch, required bitwise equal to one
   launch)
   and K3 selective scan (falcon-mamba-7b's prefill shapes, the f32
   sweep and the edges of the kernel's tiling: B/C slices not 16-byte
   aligned, states 1, 3 and 13, d_inner off the 16-byte copies, S = 32
   and 64 at full width where the copy ring has the least lead; run
   twice, bit-identical; the headline row also timed from a
   ``torch.profiler`` trace; no library call computes it).
4. serve — ``ServeEngine`` at GPT-65B full width (depth cut to
   ``SERVE_LAYERS``), bf16 params tiered across host and SSD, three requests
   (2048/1024/512-token prompts, 16 new tokens each) with a mid-run
   preempt. Checks: the three-way KV byte invariant (plan == meters ==
   closed form) exactly, every request's tokens equal to the port's
   in-memory B=1 reference decode, K1 launches == prefills x layers, and a
   small f32 model on the card agreeing with the same model on the CPU.
5. train — ``OffloadEngine`` at GPT-65B full width (depth cut to
   ``TRAIN_LAYERS``), bf16, vertical schedule, M = 4 micro-batches of
   1 x 2048 tokens, alpha = 0.25, every tier split half host / half SSD,
   2 steps then ``finish()``. Checks: (a) the measured byte meters equal
   ``plan_traffic`` x steps exactly, and the closed forms where they
   apply; (b) the losses match the port's in-memory ``make_train_step``
   from the same initial params; (c) K1 forward launches == 2 L M steps,
   K1 backward == L M steps, K2 == 3 steps; (d) gpt-tiny in f32 with
   deterministic algorithms: alpha = 0 and alpha = 0.25 losses bitwise
   equal; (e) gpt-tiny f32 on the card against the same engine on the
   CPU. Then (f) the same GPT-65B-width run under
   ``activation_policy="spill"`` (the act stream half host / half SSD)
   from the same params and tokens: bytes == plan x steps (``act``
   included) and the closed forms, losses against the same oracle, K1
   forward launches == L M steps (no forward recomputed), K1 backward ==
   L M steps, K2 == 3 steps, no act fallback, and
   ``memory_allocated`` after the last FWD no more than the recompute
   run's plus one payload (after that FWD's SPILL_ACT, no more than the
   recompute run's); (g) gpt-tiny f32 spill == recompute bitwise
   (losses and final parameters) on the card, and qwen3-4b-smoke (hd 32)
   f32 under spill on the card within 1e-5 of the CPU; (h) what
   ``"auto"`` resolves to at GPT-65B width (reported, no gate); (i)
   gpt-tiny f32 saved after step 1 and restored into a fresh engine on
   the card: step 2 bitwise the uninterrupted run's. Also measures the
   card's busy time in the training steps (CUDA events around each
   layer, embedding and head call).
6. dp — (j) ``DataParallelOffloadEngine`` of ``DP_RANKS`` = 2 simulated
   ranks on the card (the paper's multi-GPU layout: each rank owns half
   of every tiered vector, one SSD path, one I/O engine and its host
   Adam) at the train phase's width, depth, dtype, schedule, M, alpha,
   ratios, params and tokens, under recompute, 2 steps then
   ``finish()``. Checks: every rank's meters == its ``plan_traffic`` x
   steps exactly and ``dp_vertical_traffic``'s closed forms; losses
   within 1e-4 of the in-memory oracle; K1 forward launches == 2 L M
   steps, K1 backward == L M steps, K2 == 3 steps; reports the loss gap
   to the train phase's single-rank run. (k) gpt-tiny f32 with
   deterministic algorithms: 2 ranks == 1 rank bitwise (losses, final
   params and masters) at alpha 0 and 0.25; a data-parallel checkpoint
   after step 1 restored into a fresh 2-rank engine resumes bitwise; a
   mid-run ``apply_plan_config(prefetch_depth=2,
   activation_policy="spill")`` and an ``AutotuneController`` (interval
   2, 6 steps) each leave the trajectory bitwise unchanged.
7. mamba — falcon-mamba-7b at full width and depth (64 layers), bf16,
   random weights: ``prefill`` of 2 x 2048 tokens (K3 in every layer),
   32 greedy ``decode_step``s, then a fresh prefill over prompt + generated
   tokens. Checks: K3 launches == prefills x 64; the last decode step's
   logits against the fresh prefill's last logits; and the model at full
   width, 2 layers, f32 on the card against the CPU (prefill logits,
   every layer's h and conv tail, 4 decode steps).

Prints every measurement (``serve stats``, ``train stats``, ``dp stats``
and ``mamba stats`` JSON lines, the autotuner's decision log, a ``{"kernels": [...]}`` line with each kernel's
numbers), the ``nvidia-smi`` name/power-limit line, and last
``{"ok": true, "device": {...}}``.

    python3 chip_smoke.py                # what a check runs: all phases
    python3 chip_smoke.py --phases kernels
    python3 chip_smoke.py --phases dp
    python3 chip_smoke.py --phases mamba
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))
# deterministic cuBLAS needs its workspace fixed before the first cuBLAS
# call (the train phase's bitwise alpha check turns determinism on)
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

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
# the same cut for training: each GPT-65B layer is ~805 M parameters,
# ~11.3 GB of bf16 params + f32 master/m/v moved through the host Adam
# and the SSD tier every step; 2 layers keep two steps (and the host
# RAM, ~96 GiB) inside the run's limits
TRAIN_LAYERS = 2
TRAIN_M, TRAIN_MB, TRAIN_S, TRAIN_STEPS = 4, 1, 2048, 2
# the dp phase's simulated data-parallel ranks (the paper's multi-GPU
# layout, every rank on the one card): each owns half of every tiered
# vector, one SSD path, one I/O engine and its host Adam stream
DP_RANKS = 2
# loss gate against the in-memory oracle, at both steps: the two start
# from the same bf16 params and apply the same first Adam update (the
# oracle's f32 head masters and the engine's bf16 head only part from
# step 2's update on), so they differ by the order of f32 sums alone; a
# skipped layer update or a lost alpha tail moves the step-2 loss by
# far more (PERF.md, Findings)
LOSS_RTOL = 1e-4
# (name, B, Hq, Hk, S, hd, dtype, causal, window, q0)
K1_SHAPES = [
    ("gpt-65b prefill S=2048", 1, 64, 64, 2048, 128, "bfloat16", True, None, 0),
    ("gpt-65b prefill S=1024", 1, 64, 64, 1024, 128, "bfloat16", True, None, 0),
    ("gpt-65b prefill S=512", 1, 64, 64, 512, 128, "bfloat16", True, None, 0),
    ("qwen3-4b gqa S=1024", 1, 32, 8, 1024, 128, "bfloat16", True, None, 0),
    ("small f32 non-causal", 2, 4, 4, 256, 64, "float32", False, None, 0),
    ("small f32 gqa window q0", 1, 8, 2, 200, 64, "float32", True, 48, 16),
    # the bf16 kernel's edges: ragged tiles, GQA, window and q0 at hd 64;
    # ragged causal at hd 128
    ("bf16 gqa hd64 ragged window q0", 1, 8, 2, 200, 64, "bfloat16", True,
     48, 16),
    ("bf16 ragged S=1000 causal", 1, 16, 16, 1000, 128, "bfloat16", True,
     None, 0),
    # hd 32 (every SMOKE config's head dim, ArchConfig.reduced): the
    # 64-byte swizzle of the bf16 kernel and the f32 kernel's 32 columns.
    # qwen3-4b-smoke's attention as train gate (g) runs it (micro-batch 2
    # x 64 tokens, 4 heads, f32); bf16 GQA 4:1 with ragged S, a window and
    # q0; f32 at the same edges; one full-length causal row for its time
    ("qwen3-4b-smoke f32 S=64", 2, 4, 4, 64, 32, "float32", True, None, 0),
    ("bf16 gqa hd32 ragged window q0", 1, 8, 2, 200, 32, "bfloat16", True,
     48, 16),
    ("f32 gqa hd32 ragged window q0", 1, 8, 2, 200, 32, "float32", True, 48,
     16),
    ("hd32 S=2048 causal", 1, 16, 16, 2048, 32, "bfloat16", True, None, 0),
]
HEADLINE = "gpt-65b prefill S=2048"

# K1 backward: (name, B, Hq, Hk, S, hd, dtype, causal, window)
K1B_SHAPES = [
    ("gpt-65b train S=2048", 1, 64, 64, 2048, 128, "bfloat16", True, None),
    ("qwen3-4b gqa S=1024", 1, 32, 8, 1024, 128, "bfloat16", True, None),
    ("small f32 non-causal", 2, 4, 4, 256, 64, "float32", False, None),
    ("small f32 gqa window ragged", 1, 8, 2, 200, 64, "float32", True, 48),
    ("bf16 gqa hd64 ragged window", 1, 8, 2, 200, 64, "bfloat16", True, 48),
    ("bf16 ragged S=1000 causal", 1, 16, 16, 1000, 128, "bfloat16", True,
     None),
    # hd 32, as in K1_SHAPES
    ("qwen3-4b-smoke f32 S=64", 2, 4, 4, 64, 32, "float32", True, None),
    ("bf16 gqa hd32 ragged window", 1, 8, 2, 200, 32, "bfloat16", True, 48),
    ("f32 gqa hd32 ragged window", 1, 8, 2, 200, 32, "float32", True, 48),
    ("hd32 S=2048 causal", 1, 16, 16, 2048, 32, "bfloat16", True, None),
]
K1B_HEADLINE = "gpt-65b train S=2048"

# K2: (name, n, p dtype, step); n = 50304 x 8192 is GPT-65B's embedding
# (padded vocab x d_model), the largest HEAD_ADAM update
K2_CASES = [
    ("gpt-65b embed bf16 step 1", 50304 * 8192, "bfloat16", 1),
    ("gpt-65b embed bf16 step 10", 50304 * 8192, "bfloat16", 10),
    ("n=4097 f32 step 1", 4097, "float32", 1),
    ("n=4097 f32 step 10", 4097, "float32", 10),
]
K2_HEADLINE = "gpt-65b embed bf16 step 1"
# tests/test_kernels.py's K2 tolerances (atol; rtol 1e-7): p', m', v', bf16 p'
K2_TOL = (1e-6, 1e-7, 1e-7, 2e-2)

K3_DT_RANK = 256                 # falcon-mamba-7b's, for the B/C row stride
# K3: (name, B, S, di, st, dtype, offset). B and C are column slices
# of one projection whose rows hold ``offset`` + 2 st values, B starting
# at column ``offset``. The falcon-mamba-7b rows are the prefill's shapes
# and types (d_inner 8192, state 16; x, B, C, y bf16, offset dt_rank, so
# the slices are 16-byte aligned; dt, A, D f32); then tests/test_kernels.py's
# f32 sweep, and edges of the kernel's own tiling (32 channels x 32-step
# chunks; K states a thread, L lanes a channel; 16-byte or element copies):
# ragged S, di and st; B/C slices at offset 7 (not 16-byte aligned);
# st = 1 (K = 1) and 3 (one lane a channel); di not a multiple of 8 (bf16
# x) or 4 (f32 x and dt), where x and dt go by element copies
K3_SHAPES = [
    ("falcon-mamba-7b prefill B=1 S=2048", 1, 2048, 8192, 16, "bfloat16",
     K3_DT_RANK),
    ("falcon-mamba-7b prefill B=2 S=2048", 2, 2048, 8192, 16, "bfloat16",
     K3_DT_RANK),
    ("f32 (1,64,128,8)", 1, 64, 128, 8, "float32", K3_DT_RANK),
    ("f32 (2,64,256,16)", 2, 64, 256, 16, "float32", K3_DT_RANK),
    ("f32 (1,128,512,16)", 1, 128, 512, 16, "float32", K3_DT_RANK),
    ("f32 (2,96,384,4)", 2, 96, 384, 4, "float32", K3_DT_RANK),
    ("f32 ragged (3,77,1000,5)", 3, 77, 1000, 5, "float32", K3_DT_RANK),
    ("bf16 unaligned B/C (1,1000,1000,13)", 1, 1000, 1000, 13, "bfloat16",
     7),
    ("falcon-mamba-7b width B=2 S=333", 2, 333, 8192, 16, "bfloat16",
     K3_DT_RANK),
    ("f32 st=1 (2,100,256,1)", 2, 100, 256, 1, "float32", K3_DT_RANK),
    ("f32 st=3 di=301 (1,77,301,3)", 1, 77, 301, 3, "float32", 7),
    ("bf16 di=999 (2,100,999,16)", 2, 100, 999, 16, "bfloat16", 7),
    # the least lead for the cp.async ring: S inside the first one or two
    # 32-step chunks, at full width (the copies of chunk 0 and 1 are issued
    # just before their first use)
    ("falcon-mamba-7b width B=1 S=32", 1, 32, 8192, 16, "bfloat16",
     K3_DT_RANK),
    ("falcon-mamba-7b width B=2 S=32", 2, 32, 8192, 16, "bfloat16",
     K3_DT_RANK),
    ("falcon-mamba-7b width B=1 S=64", 1, 64, 8192, 16, "bfloat16",
     K3_DT_RANK),
    ("falcon-mamba-7b width B=2 S=64", 2, 64, 8192, 16, "bfloat16",
     K3_DT_RANK),
]
K3_HEADLINE = "falcon-mamba-7b prefill B=1 S=2048"
K3_ATOL_F32 = 1e-4               # tests/test_kernels.py's selective-scan atol
# h_final: max |kernel - plain| over max |plain|. h is an elementwise f32
# recurrence on both sides (no sum over states), so they differ only in
# rounding (fused multiply-adds, the exp implementation)
K3_H_RTOL = 1e-4
# the exp of every (t, d, s) runs on the special-function units: 16 per SM
# per clock on compute capability 9.0, one MUFU.EX2 per expf
SFU_PER_SM_CLOCK = 16
# falcon-mamba-7b at full width and depth (64 layers), bf16: 2 prompts of
# 2048 tokens, then greedy decode steps
MAMBA_B, MAMBA_S, MAMBA_GEN = 2, 2048, 32
# decode vs prefill: the logits of the first and the last decode step
# against the last logits of a fresh prefill over prompt + the tokens
# those steps read, ||decode - prefill|| / ||prefill||. The two paths
# differ by the reference's own rounding (prefill rounds y to bf16 before
# the gate, decode gates in f32, GEMM against GEMV sums), carried through
# 64 bf16 layers; a K3 fault moves it far more (PERF.md, Findings)
# (healthy: 0.027 at step 1, 0.069 at step 32; K3 without its D x term:
# 1.41 at both; h_final left at zero: 0.103 and 0.248). Limits per step:
DECODE_REL_TOL = {1: 0.06, MAMBA_GEN: 0.15}
# card vs CPU: full width, 2 layers, f32, one 256-token prompt. Logits and
# h within 1e-4; the conv tail within 1e-4 plus one bf16 ulp: it is the
# f32 conv input rounded to bf16, and where the two devices' f32 values
# straddle a rounding boundary they land an ulp apart. Such a flip feeds
# the next decode steps, which then part by more than 1e-4 (3.2e-4 over
# 4 steps run on from each device's own state), so each decode step
# starts on the card from the CPU's state: every step is held at 1e-4
# without compounding them
MAMBA_PARITY_LAYERS, MAMBA_PARITY_S = 2, 256
MAMBA_PARITY_TOL = 1e-4


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


def k1_bwd_work(B, Hq, Hk, S, hd, dtype, causal, window):
    """(bytes, flops) K1's backward needs on these inputs: q, k, v, out,
    dO and lse read once, dq, dk, dv written once; five products of
    2*hd FLOP (QK^T, dO V^T, P^T dO, dS K, dS^T Q) per admitted pair."""
    item = 2 if dtype == "bfloat16" else 4
    nbytes = item * hd * S * (4 * B * Hq + 4 * B * Hk) + 4 * B * Hq * S
    _, fwd_flops = k1_work(B, Hq, Hk, S, hd, dtype, causal, window, 0)
    return nbytes, fwd_flops // 4 * 10


def phase_k1_bwd(torch, fa, report):
    import torch.nn.functional as F
    rows = []
    for (name, B, Hq, Hk, S, hd, dts, causal, window) in K1B_SHAPES:
        dt = getattr(torch, dts)
        g = torch.Generator(device="cuda").manual_seed(100 + len(rows))
        q, do = (torch.randn(B, Hq, S, hd, device="cuda", generator=g).to(dt)
                 for _ in range(2))
        k, v = (torch.randn(B, Hk, S, hd, device="cuda", generator=g).to(dt)
                for _ in range(2))
        kw = dict(causal=causal, window=window)
        out, lse = fa.flash_attention_fwd(q, k, v, **kw)
        got = fa.flash_attention_bwd(q, k, v, out, do, lse, **kw)
        again = fa.flash_attention_bwd(q, k, v, out, do, lse, **kw)
        torch.cuda.synchronize()
        want = fa.flash_attention_bwd_plain(q, k, v, out, do, lse, **kw)
        tol = TOL[dts]
        err = rel_err = 0.0
        ok = all(torch.equal(a, b) for a, b in zip(got, again))
        deterministic = ok
        for a, w in zip(got, want):
            diff = (a.float() - w.float()).abs()
            err = max(err, diff.max().item())
            rel_err = max(rel_err, (diff.norm() / w.float().norm()).item())
            ok = ok and bool(torch.isfinite(a.float()).all()) and bool(
                (diff <= tol + tol * w.float().abs()).all())
        ok = ok and rel_err <= REL_TOL
        reps = 5 if S >= 1024 else 20
        ms = cuda_ms(lambda: fa.flash_attention_bwd(q, k, v, out, do, lse,
                                                    **kw), reps)
        plain_ms = cuda_ms(lambda: fa.flash_attention_bwd_plain(
            q, k, v, out, do, lse, **kw), 2, warmup=1)
        lib_ms = None
        if window is None:
            G = Hq // Hk
            qr = q.detach().requires_grad_()
            kr = k.repeat_interleave(G, dim=1).detach().requires_grad_()
            vr = v.repeat_interleave(G, dim=1).detach().requires_grad_()
            o = F.scaled_dot_product_attention(qr, kr, vr, is_causal=causal)
            lib_ms = cuda_ms(lambda: torch.autograd.grad(
                o, (qr, kr, vr), do, retain_graph=True), reps)
            del qr, kr, vr, o
        nbytes, flops = k1_bwd_work(B, Hq, Hk, S, hd, dts, causal, window)
        t_bytes = nbytes / PEAK_BYTES_S * 1e3
        t_ops = flops / PEAK_FLOPS[dts] * 1e3
        row = {"shape": name, "q": [B, Hq, S, hd], "kv_heads": Hk,
               "dtype": dts, "causal": causal, "window": window,
               "max_abs_err": err, "rel_err": rel_err, "tol": tol,
               "rel_tol": REL_TOL, "deterministic": deterministic,
               "ok": ok, "ms": ms, "plain_ms": plain_ms,
               "library_ms": lib_ms, "bound_ms": max(t_bytes, t_ops),
               "bound_by": "operations" if t_ops >= t_bytes else "bytes",
               "tflops": flops / (ms * 1e-3) / 1e12}
        rows.append(row)
        report(f"K1 bwd {name}: err {err:.3e} (tol {tol}) rel_err "
               f"{rel_err:.3e} (tol {REL_TOL}) deterministic "
               f"{deterministic} | kernel {ms:.4f} ms ({row['tflops']:.2f} "
               f"TFLOP/s) plain {plain_ms:.4f} ms sdpa-bwd {lib_ms} ms "
               f"bound {row['bound_ms']:.4f} ms ({row['bound_by']}) -> "
               f"{'OK' if ok else 'FAIL'}")
        del q, k, v, do, out, lse, got, again, want
        torch.cuda.empty_cache()
    return rows


def phase_k2(torch, fad, report):
    rows = []
    for (name, n, pdt, step) in K2_CASES:
        g = torch.Generator(device="cuda").manual_seed(200 + len(rows))
        p = torch.randn(n, device="cuda", generator=g).to(getattr(torch, pdt))
        m = torch.randn(n, device="cuda", generator=g) * 0.1
        v = torch.randn(n, device="cuda", generator=g).abs() * 0.01
        gr = torch.randn(n, device="cuda", generator=g)
        got = fad.fused_adam(p, m, v, gr, step, lr=1e-2)
        torch.cuda.synchronize()
        ok, errs = True, []
        want = fad.fused_adam_plain(p, m, v, gr, step, lr=1e-2)
        for a, w, tol in zip(got, want, K2_TOL):
            diff = (a.float() - w.float()).abs()
            errs.append(diff.max().item())
            ok = ok and bool((diff <= tol + 1e-7 * w.float().abs()).all())
        err = max(errs[:3])      # p', m', v' (the bf16 copy has its own tol)
        del want
        k = int(round(0.75 * n))
        p1, m1, v1, _ = fad.fused_adam(p, m, v, gr, step, lo=0, hi=k,
                                       lr=1e-2)
        two = fad.fused_adam(p1, m1, v1, gr, step, lo=k, hi=n, lr=1e-2)
        two_stage = all(torch.equal(a, b) for a, b in zip(got, two))
        ok = ok and two_stage
        del p1, m1, v1, two, got
        torch.cuda.empty_cache()
        reps = 10 if n > 1 << 20 else 100
        ms = cuda_ms(lambda: fad.fused_adam(p, m, v, gr, step, lr=1e-2), reps)
        plain_ms = cuda_ms(lambda: fad.fused_adam_plain(p, m, v, gr, step,
                                                        lr=1e-2),
                           max(2, reps // 5), warmup=1)
        torch.cuda.empty_cache()
        # yardstick: PyTorch's fused Adam step over an f32 copy of p
        w = p.float().clone().requires_grad_()
        w.grad = gr
        opt = torch.optim.Adam([w], lr=1e-2, betas=(0.9, 0.95), eps=1e-8,
                               fused=True)
        lib_ms = cuda_ms(opt.step, reps)
        del w, opt
        item = p.element_size()
        nbytes = n * (item + 12) + n * (12 + 2)
        t_bytes = nbytes / PEAK_BYTES_S * 1e3
        t_ops = 20 * n / PEAK_FLOPS["float32"] * 1e3
        row = {"shape": name, "n": n, "p_dtype": pdt, "step": step,
               "max_abs_err": err, "tol": list(K2_TOL),
               "two_stage_bitwise": two_stage, "ok": ok, "ms": ms,
               "plain_ms": plain_ms, "library_ms": lib_ms,
               "bound_ms": max(t_bytes, t_ops),
               "bound_by": "operations" if t_ops >= t_bytes else "bytes",
               "gbytes_per_s": nbytes / (ms * 1e-3) / 1e9}
        rows.append(row)
        report(f"K2 {name}: err {err:.3e} two-stage bitwise {two_stage} | "
               f"kernel {ms:.4f} ms ({row['gbytes_per_s']:.0f} GB/s) plain "
               f"{plain_ms:.4f} ms torch-fused-adam {lib_ms:.4f} ms bound "
               f"{row['bound_ms']:.4f} ms ({row['bound_by']}) -> "
               f"{'OK' if ok else 'FAIL'}")
        del p, m, v, gr
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
        fa.fwd_launches = 0                  # main path starts here
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
        k1_launches = fa.fwd_launches        # main path ends here
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


def meminfo() -> dict:
    """Host RAM (bytes) from /proc/meminfo."""
    out = {}
    with open("/proc/meminfo") as f:
        for ln in f:
            key, val = ln.split(":", 1)
            if key in ("MemTotal", "MemAvailable"):
                out[key] = int(val.split()[0]) * 1024
    return out


def check_train_bytes(eng, cfg, ocfg, steps):
    """Gate (a), and (f)'s bytes: measured meters == plan_traffic x steps
    per (category, route), exactly; and == the closed forms of
    core/traffic.py where they cover a route (vertical: params fetched
    twice and grads offloaded once per step, §3.4; checkpoints read twice
    minus the on-device boundary micro-batch, §4.2, or once under spill,
    whose backward reads the activation stream: L M payloads out and
    back, the tail beyond round(x_act A) through the SSD)."""
    from repro_torch.core.plan import PlanCosts, plan_traffic
    from repro_torch.core.traffic import (act_spill_traffic,
                                          vertical_ckpt_traffic)
    measured = {k: int(v) for k, v in eng.meter.bytes.items()}
    pred = {k: steps * int(v) for k, v in
            plan_traffic(eng.plan, PlanCosts.from_engine(eng)).items()}
    errs = [f"{c}:{r}: measured {measured.get((c, r), 0)} != plan "
            f"{pred.get((c, r), 0)}" for (c, r) in set(measured) | set(pred)
            if measured.get((c, r), 0) != pred.get((c, r), 0)]
    item = eng.dtype.itemsize
    L, P, M = eng.L, eng.P, ocfg.num_microbatches
    spill = eng.plan.spec.act_spill
    u = ocfg.micro_batch * ocfg.seq_len * cfg.d_model * item
    ct = vertical_ckpt_traffic(L * u, M, L, act_spill=spill)
    closed = {("param", "cpu->gpu"): 2 * L * P * item,
              ("grad", "gpu->cpu"): L * P * 4,
              ("grad", "cpu->gpu"): 0,
              ("ckpt", "gpu->cpu"): ct.write,
              ("ckpt", "cpu->gpu"): ct.read}
    if spill:
        at = act_spill_traffic(eng.act_nbytes, M, L, ocfg.ratios.act)
        closed.update({("act", "gpu->cpu"): at.spill,
                       ("act", "cpu->gpu"): at.fetch,
                       ("act", "cpu->ssd"): at.ssd_spill,
                       ("act", "ssd->cpu"): at.ssd_reread})
    for key, want in closed.items():
        if measured.get(key, 0) != steps * want:
            errs.append(f"{key[0]}:{key[1]}: measured "
                        f"{measured.get(key, 0)} != closed form "
                        f"{steps * want}")
    ig = (measured.get(("inter_grad", "gpu->cpu"), 0)
          + measured.get(("inter_grad", "cpu->gpu"), 0))
    if ig != steps * ct.inter_grad:
        errs.append(f"inter_grad: measured {ig} != closed form "
                    f"{steps * ct.inter_grad}")
    return errs, measured


def check_dp_bytes(eng, cfg, ocfg, steps):
    """Gate (j)'s bytes: every rank's meters == that rank's
    ``plan_traffic`` x steps per (category, route), exactly; and ==
    ``dp_vertical_traffic``'s closed forms on the routes they cover at
    these ratios (each rank fetches its parameter shard twice a step and
    receives the rest by all-gather, offloads its f32 gradient shard once
    and takes (R-1)/R of the f32 buffer each way in the reduce-scatter;
    its checkpoints are those of its M/R micro-batches), plus the
    replicated head's ring all-reduce."""
    from repro_torch.core.plan import PlanCosts, plan_traffic
    from repro_torch.core.traffic import dp_vertical_traffic
    preds = plan_traffic(eng.plan, PlanCosts.from_engine(eng))
    item = eng.dtype.itemsize
    L, P, M, R = eng.L, eng.P, ocfg.num_microbatches, eng.R
    u = ocfg.micro_batch * ocfg.seq_len * cfg.d_model * item
    ms = L * P * item
    errs = [] if P % R == 0 else [f"P={P} does not split evenly over "
                                  f"{R} ranks: the closed forms are for "
                                  f"equal shards"]
    t = dp_vertical_traffic(ms, L * u, M, R, grad_bytes=L * P * 4,
                            os_bytes=3 * L * P * 4, n_layers=L)
    head = 4 * (eng.embed.numel() + eng.unembed.numel()
                + eng.final_norm.numel())
    ring = 2 * (R - 1) * head // R
    closed = {("param", "cpu->gpu"): t.param_fetch,
              ("param", "net->gpu"): t.param_allgather,
              ("param", "gpu->net"): t.param_allgather,
              ("grad", "gpu->cpu"): t.grad_offload,
              ("grad", "net->gpu"): t.grad_reducescatter,
              ("grad", "gpu->net"): t.grad_reducescatter,
              ("ckpt", "gpu->cpu"): t.ckpt.write,
              ("ckpt", "cpu->gpu"): t.ckpt.read,
              ("head_grad", "gpu->net"): ring,
              ("head_grad", "net->gpu"): ring}
    measured = []
    for r, (rk, pred) in enumerate(zip(eng.ranks, preds)):
        got = {k: int(v) for k, v in rk.meter.bytes.items()}
        measured.append(got)
        want = {k: steps * int(v) for k, v in pred.items()}
        errs += [f"rank {r} {c}:{rt}: measured {got.get((c, rt), 0)} != "
                 f"plan {want.get((c, rt), 0)}"
                 for (c, rt) in set(got) | set(want)
                 if got.get((c, rt), 0) != want.get((c, rt), 0)]
        for key, per_step in closed.items():
            if got.get(key, 0) != steps * per_step:
                errs.append(f"rank {r} {key[0]}:{key[1]}: measured "
                            f"{got.get(key, 0)} != closed form "
                            f"{steps * per_step}")
        ig = (got.get(("inter_grad", "gpu->cpu"), 0)
              + got.get(("inter_grad", "cpu->gpu"), 0))
        if ig != steps * t.ckpt.inter_grad:
            errs.append(f"rank {r} inter_grad: measured {ig} != closed "
                        f"form {steps * t.ckpt.inter_grad}")
    return errs, measured


def train_engine_run(torch, fa, fad, report, cfg, params, batches,
                     workroot, policy, ranks=1):
    """One GPT-65B-width training run on the card under
    ``activation_policy=policy``: an ``OffloadEngine``, or with ``ranks``
    > 1 a ``DataParallelOffloadEngine`` of that many simulated ranks (one
    SSD path each); TRAIN_STEPS steps then ``finish()``. Returns
    (byte-gate failures, the run's numbers). The launch counts are set to
    0 after the engine is built (its construction sizes the residual
    payload with one forward) and read after ``finish()``."""
    import gc
    import threading

    from repro_torch.core.perfmodel import StorageRatios
    from repro_torch.io import IOConfig
    from repro_torch.offload import (DataParallelOffloadEngine,
                                     OffloadConfig, OffloadEngine,
                                     offload_state)

    # the layer / embedding / head work the executor runs on the card.
    # Each call is bracketed by CUDA events; the summed card time between
    # them is the device busy time (an upper bound: it also holds any gap
    # in which the card waits for the host inside a call)
    device_fns = ("j_layer_fwd", "j_layer_fwd_res", "j_layer_bwd_res",
                  "j_embed", "j_head_bwd", "j_embed_bwd", "j_adam_dev")
    # the function each plan FWD calls: the plain forward under recompute,
    # the residual-keeping one under spill
    fwd_fn = "j_layer_fwd" if policy == "recompute" else "j_layer_fwd_res"
    M, MB, S, steps = TRAIN_M, TRAIN_MB, TRAIN_S, TRAIN_STEPS
    tag = policy if ranks == 1 else f"{policy}, {ranks} ranks"
    t0 = time.perf_counter()
    workdir = tempfile.mkdtemp(prefix=f"train-{policy}-r{ranks}-",
                               dir=workroot)
    # one SSD path a rank (IOConfig.shard_for_rank hands rank r path r)
    paths = [workdir] if ranks == 1 else \
        [os.path.join(workdir, f"path{r}") for r in range(ranks)]
    ocfg = OffloadConfig(schedule="vertical", num_microbatches=M,
                         micro_batch=MB, seq_len=S, alpha=0.25,
                         ratios=StorageRatios(0.5, 0.5, 0.5, act=0.5),
                         param_dtype="bfloat16", prefetch_depth=1,
                         activation_policy=policy,
                         io=IOConfig(paths=paths, chunk_bytes=8 << 20))
    eng = None
    adam_s = [0.0] * ranks
    lock = threading.Lock()
    try:
        state = offload_state(cfg, params)
        eng = (OffloadEngine(cfg, ocfg, 0, workdir, params=state)
               if ranks == 1 else
               DataParallelOffloadEngine(cfg, ocfg, 0, workdir, ranks=ranks,
                                         params=state))
        del state
        stacks = getattr(eng, "ranks", [eng])
        gc.collect()
        torch.cuda.empty_cache()
        build_s = time.perf_counter() - t0
        report(f"train engine ({tag}) built in {build_s:.2f} s: {eng.L} "
               f"layers x {eng.P} params, residual payload A = "
               f"{eng.act_nbytes} B, host "
               f"{sum(rk.host.nbytes() for rk in stacks) / 2**30:.2f} GiB, "
               f"SSD {sum(rk.ssd.nbytes() for rk in stacks) / 2**30:.2f} "
               f"GiB")

        def timed(update, r):                 # CPU-Adam busy seconds
            def timed_update(*a, **kw):
                ts = time.perf_counter()
                update(*a, **kw)
                with lock:
                    adam_s[r] += time.perf_counter() - ts
            return timed_update
        for r, rk in enumerate(stacks):
            rk.opt_c.adam.update = timed(rk.opt_c.adam.update, r)
        spans = []                           # (call, start, end)
        mem_fwd, mem_put = [], []            # memory_allocated readings

        def on_device(name, fn):
            def timed(*a, **kw):
                ev = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
                ev[0].record()
                out = fn(*a, **kw)
                ev[1].record()
                spans.append((name, *ev))
                if name == fwd_fn:
                    mem_fwd.append(torch.cuda.memory_allocated())
                return out
            return timed
        for name in device_fns:
            setattr(eng, name, on_device(name, getattr(eng, name)))

        def measured(put):
            def measured_put(*a, **kw):
                put(*a, **kw)
                mem_put.append(torch.cuda.memory_allocated())
            return measured_put
        for rk in stacks:
            rk.act_c.put = measured(rk.act_c.put)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        # the caching allocator's device allocations and frees (cudaMalloc
        # / cudaFree synchronise, inside the CUDA-event windows too)
        alloc_keys = ("num_device_alloc", "num_device_free",
                      "num_alloc_retries")
        alloc0 = torch.cuda.memory_stats()
        fa.fwd_launches = fa.bwd_launches = fad.launches = 0  # path starts
        losses, step_s = [], []
        t_run = time.perf_counter()
        for b in batches:
            ts = time.perf_counter()
            losses.append(eng.train_step(b))
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - ts)
        tf = time.perf_counter()
        eng.finish()
        finish_s = time.perf_counter() - tf
        run_s = time.perf_counter() - t_run
        launches = (fa.fwd_launches, fa.bwd_launches, fad.launches)  # ends
        torch.cuda.synchronize()
        device_by_call = dict.fromkeys(device_fns, 0.0)
        for name, a, b in spans:
            device_by_call[name] += a.elapsed_time(b) / 1e3
        device_s = sum(device_by_call.values())
        peak = torch.cuda.max_memory_allocated()
        alloc1 = torch.cuda.memory_stats()
        allocator = {k: alloc1.get(k, 0) - alloc0.get(k, 0)
                     for k in alloc_keys}
        snap = eng.metrics_snapshot()
        if ranks == 1:
            byte_errs, measured = check_train_bytes(eng, cfg, ocfg, steps)
            by_rank = [measured]
        else:
            byte_errs, by_rank = check_dp_bytes(eng, cfg, ocfg, steps)
        host_peaks = [rk.host.peak_nbytes for rk in stacks]
        run = {
            "policy": policy, "ranks": ranks, "act_policy": eng.act_policy,
            "act_nbytes": eng.act_nbytes, "P": eng.P,
            "act_fallbacks": eng.act_fallbacks, "act_skips": eng.act_skips,
            "losses": losses, "build_s": build_s, "step_s": step_s,
            "s_per_step": sum(step_s) / len(step_s), "finish_s": finish_s,
            "run_s": run_s, "tokens_per_s": M * MB * S * len(step_s)
            / sum(step_s),
            "op_seconds": snap["op_seconds"], "stall_s": snap["stall_s"],
            "phase_time": snap["phase_time"],
            "lookahead_hit_rate": snap["lookahead"]["hit_rate"],
            "hint_skips": snap["hint_skips"],
            "cpu_adam_busy_s": sum(adam_s),
            "cpu_adam_busy_s_by_rank": list(adam_s),
            "cpu_adam_share_of_run": sum(adam_s) / run_s,
            "device_busy_s": device_s,
            "device_busy_share_of_steps": device_s / sum(step_s),
            "device_busy_s_by_call": device_by_call,
            # per rank, each its own host store's peak; their sum bounds
            # the ranks' combined peak from above
            "host_peak_nbytes": sum(host_peaks),
            "host_peak_nbytes_by_rank": host_peaks,
            "max_memory_allocated": peak,
            "allocator": allocator,
            "memory_allocated_after_last_fwd": mem_fwd[-1],
            "memory_allocated_after_last_spill":
                mem_put[-1] if mem_put else None,
            "act_bytes_per_step": sum(v for m in by_rank
                                      for (c, _), v in m.items()
                                      if c == "act") // steps,
            "launches": {"k1_fwd": launches[0], "k1_bwd": launches[1],
                         "k2": launches[2]},
            "traffic": [{f"{c}:{r}": v for (c, r), v in sorted(m.items())}
                        for m in by_rank] if ranks > 1 else
            {f"{c}:{r}": v for (c, r), v in sorted(measured.items())},
            "ocfg": ocfg,
        }
    finally:
        if eng is not None:
            eng.close()
        shutil.rmtree(workdir, ignore_errors=True)
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    report(f"train ({tag}) losses {losses} in {step_s} s/step (finish "
           f"{finish_s:.2f} s)")
    return byte_errs, run


def train_inputs(torch, cfg):
    """The training runs' initial params (bf16, seed 0, on the card) and
    token batches (seed 0): the same for the train and dp phases."""
    from repro_torch.data import SyntheticLM
    from repro_torch.models import model as mdl
    data = SyntheticLM(cfg.vocab_size, seed=0)
    batches = [data.batch(TRAIN_M * TRAIN_MB, TRAIN_S)
               for _ in range(TRAIN_STEPS)]
    return mdl.init_params(cfg, 0, dtype=torch.bfloat16), batches


def oracle_losses(torch, cfg, params, batches, lr):
    """The port's in-memory ``make_train_step`` (vertical, M micro-batches)
    from ``params`` over ``batches``: the per-step losses the offloaded
    runs are held to."""
    from repro_torch.core import (ScheduleConfig, init_train_state,
                                  make_train_step)
    from repro_torch.optim import AdamConfig
    step = make_train_step(cfg, ScheduleConfig(schedule="vertical",
                                               num_microbatches=TRAIN_M),
                           AdamConfig(lr=lr))
    _, opt = init_train_state(cfg, params=params)
    p, out = params, []
    for b in batches:
        p, opt, met = step(p, opt, {"tokens": torch.from_numpy(b).cuda()})
        out.append(float(met["loss"]))
    return out


def phase_train(torch, fa, fad, report, cfg, workroot):
    """GPT-65B-width training through ``OffloadEngine`` on the card, under
    ``activation_policy="recompute"`` and then ``"spill"`` from the same
    params and tokens; returns (failures, stats). Gates (a) bytes, (b)
    losses against the in-memory oracle, (c) launches, (f) the spill
    run's bytes, losses, launches, fallbacks and device memory; (h)
    reports what ``"auto"`` resolves to."""
    import gc

    from repro_torch.offload.engine import resolve_activation_policy

    mem = meminfo()
    disk = shutil.disk_usage(workroot)
    report(f"host RAM {mem.get('MemTotal', 0) / 2**30:.1f} GiB (available "
           f"{mem.get('MemAvailable', 0) / 2**30:.1f} GiB), disk free "
           f"{disk.free / 2**30:.1f} GiB at {workroot}")
    M, MB, S, steps = TRAIN_M, TRAIN_MB, TRAIN_S, TRAIN_STEPS
    L = cfg.num_layers
    params, batches = train_inputs(torch, cfg)
    failures = []
    runs = {}
    for policy, fwd_per_mb in (("recompute", 2), ("spill", 1)):
        errs, runs[policy] = train_engine_run(
            torch, fa, fad, report, cfg, params, batches, workroot, policy)
        failures += [f"{policy}: {e}" for e in errs]
        got = tuple(runs[policy]["launches"].values())
        # (c) / (f): a forward a micro-batch and layer under spill (none
        # recomputed), two under recompute
        want = (fwd_per_mb * L * M * steps, L * M * steps, 3 * steps)
        if got != want:
            failures.append(f"{policy}: launches (K1 fwd, K1 bwd, K2) {got} "
                            f"!= {want}")
        report(f"bytes ({policy}; plan x steps, closed forms): "
               f"{'OK' if not errs else errs}; launches (K1 fwd, K1 bwd, "
               f"K2) {got}, want {want}")
    rc, sp = runs["recompute"], runs["spill"]
    if sp["act_policy"] != "spill" or sp["act_fallbacks"] != 0:
        failures.append(f"spill run: policy {sp['act_policy']}, "
                        f"{sp['act_fallbacks']} act fallbacks (want 0)")
    # (f) the forward's graph holds no device storage once SPILL_ACT has
    # run: after the last FWD the card holds at most recompute's tensors
    # plus that FWD's payload, and once its SPILL_ACT has run, no more
    # than recompute's
    rc_mem = rc["memory_allocated_after_last_fwd"]
    mem_limit = rc_mem + sp["act_nbytes"]
    mem_ok = (sp["memory_allocated_after_last_fwd"] <= mem_limit
              and sp["memory_allocated_after_last_spill"] <= rc_mem)
    if not mem_ok:
        failures.append(f"spill: memory_allocated after the last FWD "
                        f"{sp['memory_allocated_after_last_fwd']} (limit "
                        f"recompute's {rc_mem} + one payload "
                        f"{sp['act_nbytes']}), after its SPILL_ACT "
                        f"{sp['memory_allocated_after_last_spill']} (limit "
                        f"{rc_mem})")
    report(f"memory_allocated after the last FWD: recompute "
           f"{rc_mem} B, spill {sp['memory_allocated_after_last_fwd']} B "
           f"(limit {mem_limit}: + one payload), spill after its SPILL_ACT "
           f"{sp['memory_allocated_after_last_spill']} B (limit {rc_mem}) "
           f"-> {'OK' if mem_ok else 'FAIL'}")

    # (b) the in-memory oracle from the same initial params, for both runs
    t_o = time.perf_counter()
    oracle = oracle_losses(torch, cfg, params, batches, rc["ocfg"].lr)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    oracle_s = time.perf_counter() - t_o
    rel = {}
    for policy, run in runs.items():
        losses = run["losses"]
        rel[policy] = [abs(a - b) / abs(b) for a, b in zip(losses, oracle)]
        loss_fail = [f"{policy} step {i + 1} loss {losses[i]} vs in-memory "
                     f"oracle {oracle[i]}: rel {r} > {LOSS_RTOL}"
                     for i, r in enumerate(rel[policy])
                     if not (r <= LOSS_RTOL and math.isfinite(losses[i]))]
        failures += loss_fail
        report(f"in-memory oracle losses {oracle} ({oracle_s:.1f} s) vs "
               f"{policy}: rel diff {rel[policy]} (tol {LOSS_RTOL}) -> "
               f"{'OK' if not loss_fail else 'FAIL'}")

    # (h) what "auto" resolves to at this width on the default machine
    auto_ocfg = dataclasses.replace(rc["ocfg"], activation_policy="auto")
    auto = resolve_activation_policy(auto_ocfg, cfg, sp["P"], 2,
                                     sp["act_nbytes"])
    report(f"activation_policy='auto' at {cfg.name} width (default "
           f"MachineParams, A = {sp['act_nbytes']} B) resolves to {auto!r}")
    for policy, run in runs.items():
        run.pop("ocfg")
        run["loss_rel_diff"] = rel[policy]
    stats = dict(rc)
    stats.update({
        "model": cfg.name, "layers": L, "params_per_layer": rc["P"],
        "micro_batches": M, "micro_batch": MB, "seq_len": S,
        "alpha": 0.25, "ratios": [0.5, 0.5, 0.5, 0.5], "steps": steps,
        "oracle_losses": oracle, "host_mem": mem, "disk_free": disk.free,
        "spill": sp, "auto_resolves_to": auto,
    })
    return failures, stats


def phase_train_tiny(torch, report, workroot):
    """Gates on small models in f32, under deterministic algorithms on the
    card: (d) gpt-tiny alpha = 0 and 0.25 bitwise; (e) gpt-tiny card vs
    the same engine on the CPU within 1e-5 relative; (g) gpt-tiny spill
    and recompute bitwise (losses and final parameters), qwen3-4b-smoke
    (hd 32) under spill card vs CPU within 1e-5; (i) a checkpoint saved
    after step 1 and restored into a fresh engine on the card gives step
    2's loss and parameters of the uninterrupted run bitwise."""
    import numpy as np

    from repro_torch.configs import get_config, get_smoke
    from repro_torch.core.perfmodel import StorageRatios
    from repro_torch.data import SyntheticLM
    from repro_torch.models import model as mdl
    from repro_torch.offload import OffloadConfig, OffloadEngine, offload_state

    def engine(cfg, params, device, seed=0, **kw):
        d = tempfile.mkdtemp(prefix="tiny-", dir=workroot)
        eng = OffloadEngine(cfg, OffloadConfig(
            num_microbatches=4, micro_batch=2, seq_len=64,
            ratios=StorageRatios(0.5, 0.5, 0.5, act=0.5), **kw), seed, d,
            params=None if params is None else offload_state(cfg, params),
            device=device)
        return eng, d

    def masters(eng):
        return np.concatenate([v.read() for v in eng.m_master])

    def run(cfg, params, batches, device, **kw):
        eng, d = engine(cfg, params, device, **kw)
        try:
            losses = [eng.train_step(b) for b in batches]
            eng.finish()
            fallbacks = eng.act_fallbacks
            out = (losses, masters(eng), fallbacks)
            eng.close()
        finally:
            shutil.rmtree(d, ignore_errors=True)
        return out

    cfg = get_config("gpt-tiny")
    params = mdl.init_params(cfg, 1, dtype=torch.float32, device="cpu")
    data = SyntheticLM(cfg.vocab_size, seed=1)
    batches = [data.batch(8, 64) for _ in range(3)]
    qcfg = get_smoke("qwen3-4b")
    qparams = mdl.init_params(qcfg, 2, dtype=torch.float32, device="cpu")
    qdata = SyntheticLM(qcfg.vocab_size, seed=2)
    qbatches = [qdata.batch(8, 64) for _ in range(2)]
    failures = []
    torch.use_deterministic_algorithms(True)
    try:
        l0, m0, _ = run(cfg, params, batches, "cuda")
        la, _, _ = run(cfg, params, batches, "cuda", alpha=0.25)
        ls, ms_, fb = run(cfg, params, batches, "cuda",
                          activation_policy="spill")
        lq, _, fq = run(qcfg, qparams, qbatches, "cuda",
                        activation_policy="spill")
        # (i) save after step 1, restore into a fresh engine (another
        # seed), run step 2; against the uninterrupted spill run above
        a, da = engine(cfg, params, "cuda", activation_policy="spill")
        ck = tempfile.mkdtemp(prefix="ckpt-", dir=workroot)
        db = None
        try:
            a.train_step(batches[0])
            t_s = time.perf_counter()
            a.save_checkpoint(ck)
            save_s = time.perf_counter() - t_s
            a.close()
            b, db = engine(cfg, None, "cuda", seed=99,
                           activation_policy="spill")
            t_r = time.perf_counter()
            restored = b.restore_checkpoint(ck)
            restore_s = time.perf_counter() - t_r
            resumed = [b.train_step(x) for x in batches[1:]]
            b.finish()
            mr = masters(b)
            b.close()
        finally:
            for p in (da, ck, db):
                if p:
                    shutil.rmtree(p, ignore_errors=True)
    finally:
        torch.use_deterministic_algorithms(False)
    lc, _, _ = run(cfg, params, batches, "cpu")
    lqc, _, _ = run(qcfg, qparams, qbatches, "cpu",
                    activation_policy="spill")
    if l0 != la:
        failures.append(f"gpt-tiny alpha 0 {l0} != alpha 0.25 {la} on the "
                        f"card")
    worst = max(abs(a - b) / abs(b) for a, b in zip(l0, lc))
    if not worst <= 1e-5:
        failures.append(f"gpt-tiny card {l0} vs CPU {lc}: rel {worst}")
    report(f"gpt-tiny f32 train: alpha 0 {l0} == alpha 0.25 {la}: "
           f"{l0 == la}; card vs CPU {lc}: max rel {worst:.3e} (tol 1e-5: "
           f"f32 sums in another order on each device) -> "
           f"{'OK' if not failures else 'FAIL'}")
    g_ok = ls == l0 and bool((ms_ == m0).all()) and fb == 0
    if not g_ok:
        failures.append(f"gpt-tiny spill {ls} (fallbacks {fb}) != recompute "
                        f"{l0} or final masters differ")
    qworst = max(abs(a - b) / abs(b) for a, b in zip(lq, lqc))
    q_ok = qworst <= 1e-5 and fq == 0 and all(map(math.isfinite, lq))
    if not q_ok:
        failures.append(f"qwen3-4b-smoke spill card {lq} vs CPU {lqc}: rel "
                        f"{qworst}, fallbacks {fq}")
    report(f"(g) gpt-tiny f32 spill == recompute on the card (losses and "
           f"final masters bitwise): {g_ok}; qwen3-4b-smoke (hd "
           f"{qcfg.head_dim}) f32 spill card {lq} vs CPU {lqc}: max rel "
           f"{qworst:.3e} (tol 1e-5) -> {'OK' if q_ok else 'FAIL'}")
    i_ok = (restored == 1 and resumed == ls[1:]
            and bool((mr == ms_).all()))
    if not i_ok:
        failures.append(f"checkpoint resume: restored step {restored}, "
                        f"losses {resumed} vs uninterrupted {ls[1:]}, "
                        f"masters equal {bool((mr == ms_).all())}")
    report(f"(i) gpt-tiny f32 checkpoint after step 1 (save {save_s:.2f} s, "
           f"restore {restore_s:.2f} s) resumed {resumed} == uninterrupted "
           f"{ls[1:]} and final masters bitwise: {i_ok} -> "
           f"{'OK' if i_ok else 'FAIL'}")
    return failures


def phase_dp(torch, fa, fad, report, cfg, workroot, train=None):
    """Gate (j): GPT-65B-width training through a
    ``DataParallelOffloadEngine`` of DP_RANKS simulated ranks on the card,
    from the train phase's params and tokens, under recompute (the train
    phase's engines are closed by now, so its host RAM is free). Checks
    every rank's bytes against its ``plan_traffic`` x steps and the
    closed forms, the losses against the in-memory oracle (the train
    phase's when it ran), and the launch counts; reports the loss gap to
    the train phase's single-rank run. Returns (failures, stats)."""
    import gc

    M, steps, L = TRAIN_M, TRAIN_STEPS, cfg.num_layers
    params, batches = train_inputs(torch, cfg)
    errs, run = train_engine_run(torch, fa, fad, report, cfg, params,
                                 batches, workroot, "recompute",
                                 ranks=DP_RANKS)
    failures = [f"dp: {e}" for e in errs]
    got = tuple(run["launches"].values())
    want = (2 * L * M * steps, L * M * steps, 3 * steps)
    if got != want:
        failures.append(f"dp: launches (K1 fwd, K1 bwd, K2) {got} != "
                        f"{want}")
    report(f"dp bytes (each of {DP_RANKS} ranks: plan x steps, closed "
           f"forms): {'OK' if not errs else errs}; launches (K1 fwd, K1 "
           f"bwd, K2) {got}, want {want}")
    if train:
        oracle, single = train["oracle_losses"], train["losses"]
    else:
        t_o = time.perf_counter()
        oracle = oracle_losses(torch, cfg, params, batches, run["ocfg"].lr)
        single = None
        report(f"in-memory oracle losses {oracle} "
               f"({time.perf_counter() - t_o:.1f} s)")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    run.pop("ocfg")
    losses = run["losses"]
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, oracle)]
    loss_fail = [f"dp step {i + 1} loss {losses[i]} vs in-memory oracle "
                 f"{oracle[i]}: rel {r} > {LOSS_RTOL}"
                 for i, r in enumerate(rel)
                 if not (r <= LOSS_RTOL and math.isfinite(losses[i]))]
    failures += loss_fail
    gap = None if single is None else \
        [abs(a - b) / abs(b) for a, b in zip(losses, single)]
    report(f"dp losses {losses} vs in-memory oracle {oracle}: rel diff "
           f"{rel} (tol {LOSS_RTOL}) -> {'OK' if not loss_fail else 'FAIL'};"
           f" vs the single-rank run {single}: rel gap {gap}")
    run.update({"model": cfg.name, "layers": L, "params_per_layer": run["P"],
                "micro_batches": M, "micro_batch": TRAIN_MB,
                "seq_len": TRAIN_S, "alpha": 0.25,
                "ratios": [0.5, 0.5, 0.5, 0.5], "steps": steps,
                "oracle_losses": oracle, "loss_rel_diff": rel,
                "single_rank_losses": single,
                "loss_rel_gap_to_single_rank": gap})
    return failures, run


def phase_dp_tiny(torch, report, workroot):
    """Gates (k), gpt-tiny in f32 under deterministic algorithms on the
    card: DP_RANKS ranks == one rank bitwise (losses, final low-precision
    params and masters) at alpha 0 and 0.25; a data-parallel checkpoint
    saved after step 1 and restored into a fresh engine of DP_RANKS
    ranks (another seed) gives the uninterrupted run's later steps
    bitwise; a mid-run ``apply_plan_config(prefetch_depth=2,
    activation_policy="spill")`` leaves the trajectory bitwise
    unchanged; an ``AutotuneController`` (interval 2, 6 steps) left on
    gives the trajectory of the run with it off, bitwise. Returns
    (failures, the controller's decision log)."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core.perfmodel import StorageRatios
    from repro_torch.data import SyntheticLM
    from repro_torch.models import model as mdl
    from repro_torch.offload import (AutotuneConfig, AutotuneController,
                                     DataParallelOffloadEngine,
                                     OffloadConfig, OffloadEngine,
                                     offload_state)

    cfg = get_config("gpt-tiny")
    params = mdl.init_params(cfg, 1, dtype=torch.float32, device="cpu")
    data = SyntheticLM(cfg.vocab_size, seed=1)
    batches = [data.batch(8, 64) for _ in range(6)]
    dirs = []

    def engine(ranks, alpha, seed=0, init=True):
        d = tempfile.mkdtemp(prefix=f"dp-tiny-r{ranks}-", dir=workroot)
        dirs.append(d)
        ocfg = OffloadConfig(num_microbatches=4, micro_batch=2, seq_len=64,
                             alpha=alpha,
                             ratios=StorageRatios(0.5, 0.5, 0.5, act=0.5))
        state = offload_state(cfg, params) if init else None
        if ranks == 1:
            return OffloadEngine(cfg, ocfg, seed, d, params=state,
                                 device="cuda")
        return DataParallelOffloadEngine(cfg, ocfg, seed, d, ranks=ranks,
                                         params=state, device="cuda")

    def result(eng, losses):
        eng.finish()
        stacks = getattr(eng, "ranks", [eng])
        out = (losses,
               [np.concatenate([rk.p_vecs[l].read() for rk in stacks])
                for l in range(eng.L)],
               [np.concatenate([rk.m_master[l].read() for rk in stacks])
                for l in range(eng.L)],
               eng.act_fallbacks)
        eng.close()
        return out

    def run(ranks, alpha, n=3, hook=None):
        """``hook(eng)`` runs once the engine is built and returns the
        function called after each step (with the step's index)."""
        eng = engine(ranks, alpha)
        after = hook(eng) if hook is not None else None
        losses = []
        for i, b in enumerate(batches[:n]):
            losses.append(eng.train_step(b))
            if after is not None:
                after(i)
        return result(eng, losses)

    def same(a, b):
        return (a[0] == b[0] and a[3] == b[3] == 0
                and all(bool((x == y).all()) for x, y in zip(a[1], b[1]))
                and all(bool((x == y).all()) for x, y in zip(a[2], b[2])))

    failures = []
    log = []
    torch.use_deterministic_algorithms(True)
    try:
        bitwise = {}
        for alpha in (0.0, 0.25):
            one = run(1, alpha)
            dp = run(DP_RANKS, alpha)
            bitwise[alpha] = (same(one, dp), one[0], dp[0])
        ref = dp                                  # DP_RANKS, alpha 0.25
        # checkpoint after step 1, restored into a fresh engine
        a = engine(DP_RANKS, 0.25)
        first = [a.train_step(batches[0])]
        ck = tempfile.mkdtemp(prefix="dp-ckpt-", dir=workroot)
        dirs.append(ck)
        t_s = time.perf_counter()
        a.save_checkpoint(ck)
        save_s = time.perf_counter() - t_s
        a.close()
        b = engine(DP_RANKS, 0.25, seed=99, init=False)
        restored = b.restore_checkpoint(ck)
        resumed = result(b, first + [b.train_step(x)
                                     for x in batches[1:3]])
        ck_ok = restored == 1 and same(resumed, ref)
        # the plan hot swap after step 1

        def swap(eng):
            def after(i):
                if i == 0:
                    eng.apply_plan_config(prefetch_depth=2,
                                          activation_policy="spill")
            return after
        swapped = run(DP_RANKS, 0.25, hook=swap)
        swap_ok = same(swapped, ref)
        # the autotuner on vs off over 6 steps; its candidates are the
        # knobs that leave the trajectory bitwise unchanged
        off = run(DP_RANKS, 0.25, n=6)

        def tune(eng):
            ctl = AutotuneController(eng, AutotuneConfig(
                interval=2, hysteresis=0.0, cooldown=0,
                prefetch_depths=(0, 1, 2),
                act_policies=("recompute", "spill")))
            ctls.append(ctl)
            return lambda i: ctl.post_step()
        ctls = []
        on = run(DP_RANKS, 0.25, n=6, hook=tune)
        log = ctls[0].decisions
        tune_ok = same(on, off)
    finally:
        torch.use_deterministic_algorithms(False)
        for d in dirs:
            shutil.rmtree(d, ignore_errors=True)
    for alpha, (ok, l1, lr) in bitwise.items():
        if not ok:
            failures.append(f"gpt-tiny alpha {alpha}: {DP_RANKS} ranks {lr} "
                            f"!= one rank {l1} (or final params differ)")
        report(f"(k) gpt-tiny f32 alpha {alpha}: {DP_RANKS} ranks == one "
               f"rank (losses, params, masters bitwise): {ok} "
               f"({lr}) -> {'OK' if ok else 'FAIL'}")
    if not ck_ok:
        failures.append(f"dp checkpoint resume: restored step {restored}, "
                        f"losses {resumed[0]} vs uninterrupted {ref[0]}")
    report(f"(k) dp checkpoint after step 1 (save {save_s:.2f} s) restored "
           f"into a fresh {DP_RANKS}-rank engine: {resumed[0]} == "
           f"{ref[0]} with params and masters bitwise: {ck_ok} -> "
           f"{'OK' if ck_ok else 'FAIL'}")
    if not swap_ok:
        failures.append(f"dp plan swap: {swapped[0]} vs unswapped {ref[0]} "
                        f"(fallbacks {swapped[3]})")
    report(f"(k) apply_plan_config(prefetch_depth=2, activation_policy="
           f"'spill') after step 1: {swapped[0]} == unswapped, params and "
           f"masters bitwise: {swap_ok} -> {'OK' if swap_ok else 'FAIL'}")
    if not tune_ok:
        failures.append(f"dp autotune on {on[0]} != off {off[0]}")
    report(f"(k) autotune on (interval 2, 6 steps) {on[0]} == off "
           f"{off[0]}, params and masters bitwise: {tune_ok} -> "
           f"{'OK' if tune_ok else 'FAIL'}")
    report("autotune decisions: " + json.dumps(
        [{k: d.get(k) for k in ("window", "step", "action", "reason",
                                "changes", "route_error", "current",
                                "best")} for d in log]))
    return failures, log


def sfu_exps_per_s() -> float:
    """The card's exp rate: SMs x SFU_PER_SM_CLOCK x its maximum SM clock
    (``nvidia-smi --query-gpu=clocks.max.sm``)."""
    import torch
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60)
    mhz = float(out.stdout.strip().splitlines()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return sms * SFU_PER_SM_CLOCK * mhz * 1e6


def k3_work(B, S, di, st, dtype):
    """(bytes, f32 operations, exps) K3 needs on these inputs: x and y in
    ``dtype``, dt f32 and B, C in ``dtype`` read or written once, A, D
    and h_final f32; per (t, d, s) 6 f32 operations (dt A, da h, dx B,
    the add, h C and its share of the sum over s) and one exp, per
    (t, d) 3 more (dt x, D x, the add)."""
    item = 2 if dtype == "bfloat16" else 4
    nbytes = (B * S * di * (2 * item + 4) + 2 * B * S * st * item
              + 4 * (di * st + di + B * di * st))
    return nbytes, B * S * di * (6 * st + 3), B * S * di * st


def k3_inputs(torch, B, S, di, st, dtype, offset, seed):
    """The model path's inputs (``dtype`` x, B, C with B and C strided
    slices of one projection, from column ``offset``; f32 dt, A, D).
    bf16 rows: falcon-mamba-7b's S4D-real A and a dt around softplus(-4)
    ~ 0.018; f32 rows: tests/test_kernels.py's distributions."""
    dt_ = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = (torch.randn(B, S, di, device="cuda", generator=g) * 0.5).to(dt_)
    proj = torch.randn(B, S, offset + 2 * st, device="cuda",
                       generator=g).to(dt_)
    Bc = proj[..., offset:offset + st]
    Cc = proj[..., offset + st:]
    if dtype == "bfloat16":
        dt = torch.nn.functional.softplus(
            torch.randn(B, S, di, device="cuda", generator=g) * 0.5 - 4.0)
        A = -torch.arange(1, st + 1, dtype=torch.float32,
                          device="cuda")[None, :].repeat(di, 1)
        D = torch.ones(di, device="cuda")
    else:
        dt = torch.nn.functional.softplus(
            torch.randn(B, S, di, device="cuda", generator=g) * 0.2)
        A = -torch.exp(torch.randn(di, st, device="cuda", generator=g) * 0.3)
        D = 1.0 + 0.1 * torch.randn(di, device="cuda", generator=g)
    return x, dt, A, Bc, Cc, D


def profiled_kernel_ms(torch, fn, kernel: str, reps: int) -> dict:
    """``reps`` calls of ``fn`` under ``torch.profiler`` (CUDA activity):
    the mean device duration of the kernels whose name holds ``kernel``
    (None if the trace has none) and the host's wall time per call up to
    the last enqueue, in ms."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        host = time.perf_counter() - t0
        torch.cuda.synchronize()
    evs = [e for e in prof.key_averages() if kernel in e.key]
    n = sum(e.count for e in evs)
    dev = sum(e.self_device_time_total for e in evs)
    return {"kernel_ms": dev / n / 1e3 if n else None, "kernels": n,
            "host_ms_per_call": 1e3 * host / reps}


def phase_k3(torch, k3, report):
    """K3 against its plain version on the card: the model path's bf16
    shapes and the f32 sweep; two launches bitwise equal; timed beside
    its bound and the plain version (no PyTorch call computes a selective
    scan, so there is no library time)."""
    exp_rate = sfu_exps_per_s()
    rows = []
    for (name, B, S, di, st, dts, offset) in K3_SHAPES:
        ins = k3_inputs(torch, B, S, di, st, dts, offset, 300 + len(rows))
        y, h = k3.selective_scan_fwd(*ins)
        y2, h2 = k3.selective_scan_fwd(*ins)
        torch.cuda.synchronize()
        deterministic = torch.equal(y, y2) and torch.equal(h, h2)
        ry, rh = k3.selective_scan_plain(*ins)
        dy = (y.float() - ry.float()).abs()
        err = dy.max().item()
        rel_err = (dy.norm() / ry.float().norm()).item()
        h_rel = ((h - rh).abs().max() / rh.abs().max()).item()
        if dts == "float32":
            tol = K3_ATOL_F32
            y_ok = err <= tol
        else:
            tol = TOL[dts]
            y_ok = bool((dy <= tol + tol * ry.float().abs()).all()) \
                and rel_err <= REL_TOL
        ok = (deterministic and y_ok and h_rel <= K3_H_RTOL
              and bool(torch.isfinite(y.float()).all())
              and bool(torch.isfinite(h).all()))
        del y2, h2, ry, rh, dy
        big = S * di >= 1 << 20
        ms = cuda_ms(lambda: k3.selective_scan_fwd(*ins), 20 if big else 100)
        plain_ms = cuda_ms(lambda: k3.selective_scan_plain(*ins),
                           2 if big else 5, warmup=1)
        nbytes, ops, exps = k3_work(B, S, di, st, dts)
        t_bytes = nbytes / PEAK_BYTES_S * 1e3
        t_ops = max(ops / PEAK_FLOPS["float32"], exps / exp_rate) * 1e3
        row = {"shape": name, "x": [B, S, di], "state": st, "dtype": dts,
               "max_abs_err": err, "rel_err": rel_err,
               "h_max_rel_err": h_rel, "tol": tol, "h_rtol": K3_H_RTOL,
               "deterministic": deterministic, "ok": ok, "ms": ms,
               "plain_ms": plain_ms, "library_ms": None,
               "bound_ms": max(t_bytes, t_ops),
               "bound_by": "operations" if t_ops >= t_bytes else "bytes",
               "bytes_ms": t_bytes,
               "f32_ops_ms": ops / PEAK_FLOPS["float32"] * 1e3,
               "exp_ms": exps / exp_rate * 1e3, "exps_per_s": exp_rate,
               "gbytes_per_s": nbytes / (ms * 1e-3) / 1e9}
        if name == K3_HEADLINE:   # the kernel's own duration, beside ms
            row["profiler"] = profiled_kernel_ms(
                torch, lambda: k3.selective_scan_fwd(*ins),
                "selective_scan_kernel", 20)
            report(f"K3 {name}: torch.profiler kernel duration "
                   f"{row['profiler']['kernel_ms']} ms over "
                   f"{row['profiler']['kernels']} launches, host "
                   f"{row['profiler']['host_ms_per_call']:.4f} ms a call, "
                   f"CUDA events {ms:.4f} ms a call")
        rows.append(row)
        report(f"K3 {name}: err {err:.3e} (tol {tol}) rel_err "
               f"{rel_err:.3e} h rel {h_rel:.3e} (tol {K3_H_RTOL}) "
               f"deterministic {deterministic} | kernel {ms:.4f} ms "
               f"({row['gbytes_per_s']:.0f} GB/s) plain {plain_ms:.4f} ms "
               f"bound {row['bound_ms']:.4f} ms ({row['bound_by']}: bytes "
               f"{t_bytes:.4f}, f32 ops {row['f32_ops_ms']:.4f}, exps "
               f"{row['exp_ms']:.4f}) -> {'OK' if ok else 'FAIL'}")
        del ins, y, h
        torch.cuda.empty_cache()
    return rows


def mamba_parity(torch, report):
    """falcon-mamba-7b at full width, ``MAMBA_PARITY_LAYERS`` layers, f32:
    the card (K3 in prefill) against the CPU (the plain scan) on the
    prefill's logits and every layer's h and conv tail, then on 4 decode
    steps, each started on the card from the CPU's state and token (see
    ``MAMBA_PARITY_LAYERS``)."""
    import numpy as np

    from repro_torch import tree
    from repro_torch.configs import get_config
    from repro_torch.models import model as mdl
    cfg = dataclasses.replace(get_config("falcon-mamba-7b"),
                              num_layers=MAMBA_PARITY_LAYERS)
    params = mdl.init_params(cfg, 1, dtype=torch.float32, device="cpu")
    pg = tree.tree_map(lambda a: a.cuda(), params)
    prompt = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (1, MAMBA_PARITY_S)))
    cc = mdl.init_caches(cfg, 1, MAMBA_PARITY_S + 4, dtype=torch.float32,
                         device="cpu")
    cg = mdl.init_caches(cfg, 1, MAMBA_PARITY_S + 4, dtype=torch.float32)
    lc, cc = mdl.prefill(params, cfg, {"tokens": prompt}, cc)
    lg, cg = mdl.prefill(pg, cfg, {"tokens": prompt.cuda()}, cg)

    def compare(step, lc, lg):
        conv_c, h_c = tree.leaves(cc)
        conv_g, h_g = (t.cpu() for t in tree.leaves(cg))
        dconv = (conv_c.float() - conv_g.float()).abs()
        return {"step": step,
                "logits": (lc - lg.cpu()).abs().max().item(),
                "h": (h_c - h_g).abs().max().item(),
                "conv_ok": bool((dconv <= MAMBA_PARITY_TOL + 2 ** -7
                                 * conv_c.float().abs()).all()),
                "conv_flips": int((dconv > 0).sum()),
                "finite": bool(torch.isfinite(lg).all())}
    rows = [compare(0, lc, lg)]
    for i in range(4):
        with torch.no_grad():                # the CPU's state on the card
            for dst, src in zip(tree.leaves(cg), tree.leaves(cc)):
                dst.copy_(src)
        tok = torch.argmax(lc, dim=-1)[:, None]
        lc, cc = mdl.decode_step(params, cfg, tok, MAMBA_PARITY_S + i, cc)
        lg, cg = mdl.decode_step(pg, cfg, tok.cuda(), MAMBA_PARITY_S + i, cg)
        rows.append(compare(i + 1, lc, lg))
    del pg, cg
    torch.cuda.empty_cache()
    worst = max(r["logits"] for r in rows)
    h_err = max(r["h"] for r in rows)
    ok = (worst <= MAMBA_PARITY_TOL and h_err <= MAMBA_PARITY_TOL
          and all(r["conv_ok"] and r["finite"] for r in rows))
    report(f"falcon-mamba-7b width, {MAMBA_PARITY_LAYERS} layers, f32, card "
           f"vs CPU (prefill, then 4 decode steps from the CPU's state): "
           f"logits max abs diff {worst:.3e}, h {h_err:.3e} (tol "
           f"{MAMBA_PARITY_TOL}), conv tail within {MAMBA_PARITY_TOL} + one "
           f"bf16 ulp {all(r['conv_ok'] for r in rows)} (elements that "
           f"differ by step {[r['conv_flips'] for r in rows]}) -> "
           f"{'OK' if ok else 'FAIL'}")
    return ([] if ok else [f"falcon-mamba card/CPU differ: {rows}"]), rows


def card_busy(torch, fn) -> dict:
    """Run ``fn`` once under ``torch.profiler`` (CUDA activity only):
    the summed device time of its kernels and copies, and the host wall
    time to its end, synchronised, in ms."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy = sum(e.self_device_time_total for e in prof.key_averages()) / 1e3
    return {"busy_ms": busy, "wall_ms": 1e3 * wall,
            "busy_share": busy / (1e3 * wall)}


def phase_mamba(torch, k3, report):
    """falcon-mamba-7b at full width and depth, bf16, on the card:
    prefill of ``MAMBA_B`` x ``MAMBA_S`` tokens, ``MAMBA_GEN`` greedy
    decode steps, then a fresh prefill over prompt + generated tokens.
    Gates: K3 launches == prefills x layers; decode vs prefill; card vs
    CPU (:func:`mamba_parity`). Returns (failures, stats)."""
    import gc

    from repro_torch import tree
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLM
    from repro_torch.models import model as mdl

    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_config("falcon-mamba-7b")
    B, S, gen = MAMBA_B, MAMBA_S, MAMBA_GEN
    t0 = time.perf_counter()
    params = mdl.init_params(cfg, 0, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    nparams = sum(t.numel() for t in tree.leaves(params))
    prompts = torch.from_numpy(SyntheticLM(cfg.vocab_size, seed=0)
                               .batch(B, S)).cuda()
    # K3's card time inside prefill: CUDA events around each scan call
    scan_spans = []
    real_scan = k3.selective_scan_fwd

    def timed_scan(*a):
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        ev[0].record()
        out = real_scan(*a)
        ev[1].record()
        scan_spans.append(ev)
        return out
    k3.selective_scan_fwd = timed_scan
    try:
        caches = mdl.init_caches(cfg, B, S + gen, dtype=torch.bfloat16)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        k3.launches = 0                              # main path starts here
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        t0 = time.perf_counter()
        ev[0].record()
        logits, caches = mdl.prefill(params, cfg, {"tokens": prompts},
                                     caches)
        ev[1].record()
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        prefill_card_ms = ev[0].elapsed_time(ev[1])
        scan_ms = sum(a.elapsed_time(b) for a, b in scan_spans)
        n_scans = len(scan_spans)
        toks, step_s, decoded = [], [], {}
        tok = torch.argmax(logits, dim=-1)[:, None]
        for i in range(gen):
            toks.append(tok)
            ts = time.perf_counter()
            logits, caches = mdl.decode_step(params, cfg, tok, S + i, caches)
            tok = torch.argmax(logits, dim=-1)[:, None]
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - ts)
            if i + 1 in DECODE_REL_TOL:
                decoded[i + 1] = logits
        del caches
        # a fresh prefill over prompt + the tokens each checked step read
        fresh, prefill2_s = {}, []
        for n in DECODE_REL_TOL:
            full = torch.cat([prompts] + toks[:n], dim=1)   # (B, S + n)
            c = mdl.init_caches(cfg, B, S + n, dtype=torch.bfloat16)
            t1 = time.perf_counter()
            fresh[n], _ = mdl.prefill(params, cfg, {"tokens": full}, c)
            torch.cuda.synchronize()
            prefill2_s.append(time.perf_counter() - t1)
            del c
        launches = k3.launches                       # main path ends here
        peak = torch.cuda.max_memory_allocated()
        # the card's busy time (kernels, from a torch.profiler trace) in one
        # more prefill of the prompt and two more decode steps
        c = mdl.init_caches(cfg, B, S + 2, dtype=torch.bfloat16)
        busy = {"prefill": card_busy(torch, lambda: mdl.prefill(
            params, cfg, {"tokens": prompts}, c))}
        busy["decode_2_steps"] = card_busy(torch, lambda: [mdl.decode_step(
            params, cfg, toks[i], S + i, c) for i in range(2)])
        del c
    finally:
        k3.selective_scan_fwd = real_scan
    del params
    gc.collect()
    torch.cuda.empty_cache()

    failures = []
    n_prefills = 1 + len(DECODE_REL_TOL)
    if launches != n_prefills * cfg.num_layers:
        failures.append(f"K3 launches {launches} != prefills {n_prefills} x "
                        f"layers {cfg.num_layers}")
    checks = []
    for n in DECODE_REL_TOL:
        got, want = decoded[n].float(), fresh[n].float()
        rel = ((got - want).norm() / want.norm()).item()
        ok = rel <= DECODE_REL_TOL[n] and bool(torch.isfinite(got).all()) \
            and bool(torch.isfinite(want).all())
        checks.append({"step": n, "rel": rel, "tol": DECODE_REL_TOL[n],
                       "ok": ok,
                       "max_abs": (got - want).abs().max().item(),
                       "logit_scale": want.abs().max().item(),
                       "argmax_agree": (torch.argmax(got, -1)
                                        == torch.argmax(want, -1)).tolist()})
        if not ok:
            failures.append(f"decode step {n} vs a fresh prefill: rel {rel} "
                            f"> {DECODE_REL_TOL[n]}")
    report("falcon-mamba-7b decode vs a fresh prefill over prompt + "
           "generated tokens: " + "; ".join(
               f"step {c['step']} rel {c['rel']:.4e} (tol {c['tol']}) max abs "
               f"{c['max_abs']:.4e} (logits up to {c['logit_scale']:.3f}) "
               f"argmax agree {c['argmax_agree']} "
               f"{'OK' if c['ok'] else 'FAIL'}" for c in checks))
    f, parity = mamba_parity(torch, report)
    failures += f
    dec = sorted(step_s[1:]) or step_s
    stats = {
        "model": cfg.name, "layers": cfg.num_layers, "params": nparams,
        "batch": B, "prompt": S, "gen": gen, "init_s": init_s,
        "prefill_s": prefill_s, "prefill_card_ms": prefill_card_ms,
        "prefill_tokens_per_s": B * S / prefill_s,
        "fresh_prefill_s": prefill2_s,
        "fresh_prefill_tokens_per_s": B * (S + gen) / prefill2_s[-1],
        "k3_ms_in_prefill": scan_ms, "k3_calls_in_prefill": n_scans,
        "k3_share_of_prefill": scan_ms / prefill_card_ms,
        "decode_step_s": step_s,
        "decode_step_s_median": dec[len(dec) // 2],
        "decode_tokens_per_s": B * gen / sum(step_s),
        "k3_launches": launches,
        "decode_vs_prefill": checks, "card_vs_cpu": parity,
        "card_busy": busy,
        "max_memory_allocated": peak,
    }
    return failures, stats


def _kernel_entry(name, source, replaces, launches, rows, headline,
                  smi, **extra):
    head = next((r for r in rows if r["shape"] == headline), None)
    entry = {"name": name, "route": "cuda", "source": source,
             "replaces": replaces, "launches": launches,
             "max_abs_err": max((r["max_abs_err"] for r in rows),
                                default=None)}
    for key in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms"):
        entry[key] = head[key] if head else None
    entry.update(at=headline, card=smi, shapes=rows, **extra)
    return entry


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default="kernels,serve,train,dp,mamba",
                    help="comma list of: kernels, serve, train, dp, mamba")
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
        from repro_torch.kernels import fused_adam as fad
        from repro_torch.kernels import selective_scan as k3
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
    rows, brows, arows, srows = [], [], [], []
    wall = {}
    workroot = os.path.join(ROOT, "_work")
    os.makedirs(workroot, exist_ok=True)
    # 3. kernels
    if "kernels" in phases:
        t0 = time.perf_counter()
        rows = phase_kernels(torch, fa, report)
        failures += [f"K1 {r['shape']}: err {r['max_abs_err']} rel_err "
                     f"{r['rel_err']} lse_err {r['lse_max_abs_err']}"
                     for r in rows if not r["ok"]]
        brows = phase_k1_bwd(torch, fa, report)
        failures += [f"K1 bwd {r['shape']}: err {r['max_abs_err']} rel_err "
                     f"{r['rel_err']} deterministic {r['deterministic']}"
                     for r in brows if not r["ok"]]
        arows = phase_k2(torch, fad, report)
        failures += [f"K2 {r['shape']}: err {r['max_abs_err']} two-stage "
                     f"bitwise {r['two_stage_bitwise']}"
                     for r in arows if not r["ok"]]
        srows = phase_k3(torch, k3, report)
        failures += [f"K3 {r['shape']}: err {r['max_abs_err']} rel_err "
                     f"{r['rel_err']} h rel {r['h_max_rel_err']} "
                     f"deterministic {r['deterministic']}"
                     for r in srows if not r["ok"]]
        wall["kernels"] = time.perf_counter() - t0
    # 4. serve
    stats = {}
    if "serve" in phases:
        t0 = time.perf_counter()
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
        wall["serve"] = time.perf_counter() - t0
    # 5. train
    tstats = {}
    if "train" in phases:
        t0 = time.perf_counter()
        full = get_config("gpt-65b")
        cfg = dataclasses.replace(full, num_layers=TRAIN_LAYERS)
        report(f"train model: {full.name} at full width (d_model "
               f"{cfg.d_model}, {cfg.num_heads} heads x {cfg.head_dim}, d_ff "
               f"{cfg.d_ff}, vocab {cfg.vocab_size} -> {cfg.padded_vocab}), "
               f"depth cut {full.num_layers} -> {cfg.num_layers} layers, "
               f"bf16, vertical, M {TRAIN_M} x {TRAIN_MB} x {TRAIN_S} tokens, "
               f"alpha 0.25, ratios 0.5/0.5/0.5 (act 0.5), {TRAIN_STEPS} "
               f"steps, activation_policy recompute then spill")
        f, tstats = phase_train(torch, fa, fad, report, cfg, workroot)
        failures += f
        failures += phase_train_tiny(torch, report, workroot)
        for run in (tstats, tstats["spill"]):
            report(f"train {run['policy']} ({smi}): "
                   f"{run['s_per_step']:.2f} s/step, "
                   f"{run['tokens_per_s']:.1f} tokens/s, A "
                   f"{run['act_nbytes']} B, act bytes/step "
                   f"{run['act_bytes_per_step']}, stall "
                   f"{run['stall_s']:.2f} s, phase time "
                   f"{json.dumps(run['phase_time'])}, lookahead hit rate "
                   f"{run['lookahead_hit_rate']:.3f}, CPU Adam busy "
                   f"{run['cpu_adam_busy_s']:.2f} s "
                   f"({100 * run['cpu_adam_share_of_run']:.1f} % of the "
                   f"run), device busy {run['device_busy_s']:.3f} s "
                   f"({100 * run['device_busy_share_of_steps']:.2f} % of the "
                   f"steps), host peak "
                   f"{run['host_peak_nbytes'] / 2**30:.2f} GiB, "
                   f"max_memory_allocated "
                   f"{run['max_memory_allocated'] / 2**30:.2f} GiB")
            report(f"train {run['policy']} op seconds: "
                   + json.dumps(run["op_seconds"]))
        report("train stats: " + json.dumps(tstats))
        wall["train"] = time.perf_counter() - t0
    # 6. dp
    dstats = {}
    if "dp" in phases:
        t0 = time.perf_counter()
        full = get_config("gpt-65b")
        cfg = dataclasses.replace(full, num_layers=TRAIN_LAYERS)
        report(f"dp model: {full.name} at full width, depth cut "
               f"{full.num_layers} -> {cfg.num_layers} layers, bf16, "
               f"{DP_RANKS} simulated data-parallel ranks on the one card "
               f"(one SSD path, I/O engine and host Adam each), vertical, "
               f"M {TRAIN_M} x {TRAIN_MB} x {TRAIN_S} tokens, alpha 0.25, "
               f"ratios 0.5/0.5/0.5, {TRAIN_STEPS} steps, recompute")
        f, dstats = phase_dp(torch, fa, fad, report, cfg, workroot,
                             train=tstats or None)
        failures += f
        f, dstats["autotune_log"] = phase_dp_tiny(torch, report, workroot)
        failures += f
        report(f"dp ({smi}): {dstats['s_per_step']:.2f} s/step, "
               f"{dstats['tokens_per_s']:.1f} tokens/s, stall "
               f"{dstats['stall_s']:.2f} s, phase time "
               f"{json.dumps(dstats['phase_time'])}, CPU Adam busy "
               f"{dstats['cpu_adam_busy_s']:.2f} s (by rank "
               f"{[round(x, 2) for x in dstats['cpu_adam_busy_s_by_rank']]}"
               f", {100 * dstats['cpu_adam_share_of_run']:.1f} % of the run "
               f"summed), device busy {dstats['device_busy_s']:.3f} s "
               f"({100 * dstats['device_busy_share_of_steps']:.2f} % of the "
               f"steps), host peak "
               f"{dstats['host_peak_nbytes'] / 2**30:.2f} GiB (by rank "
               f"{[round(x / 2**30, 2) for x in dstats['host_peak_nbytes_by_rank']]}"
               f" GiB), max_memory_allocated "
               f"{dstats['max_memory_allocated'] / 2**30:.2f} GiB, loss gap "
               f"to one rank {dstats['loss_rel_gap_to_single_rank']}")
        report("dp op seconds: " + json.dumps(dstats["op_seconds"]))
        report("dp stats: " + json.dumps(dstats))
        wall["dp"] = time.perf_counter() - t0
    # 7. mamba
    mstats = {}
    if "mamba" in phases:
        t0 = time.perf_counter()
        cfg = get_config("falcon-mamba-7b")
        report(f"mamba model: {cfg.name} at full width and depth (d_model "
               f"{cfg.d_model}, d_inner {cfg.d_inner}, state "
               f"{cfg.ssm_state}, conv {cfg.ssm_conv}, dt_rank "
               f"{cfg.dt_rank}, {cfg.num_layers} layers, vocab "
               f"{cfg.vocab_size}), bf16, {MAMBA_B} x {MAMBA_S} prompt "
               f"tokens, {MAMBA_GEN} greedy decode steps")
        f, mstats = phase_mamba(torch, k3, report)
        failures += f
        report(f"mamba ({smi}): prefill {mstats['prefill_s']:.3f} s "
               f"({mstats['prefill_tokens_per_s']:.0f} tokens/s), K3 "
               f"{100 * mstats['k3_share_of_prefill']:.2f} % of the "
               f"prefill's card time, decode "
               f"{mstats['decode_tokens_per_s']:.1f} tokens/s (median step "
               f"{1e3 * mstats['decode_step_s_median']:.2f} ms), card busy "
               f"{100 * mstats['card_busy']['prefill']['busy_share']:.1f} % "
               f"of a prefill and "
               f"{100 * mstats['card_busy']['decode_2_steps']['busy_share']:.1f}"
               f" % of two decode steps, K3 launches "
               f"{mstats['k3_launches']}, max_memory_allocated "
               f"{mstats['max_memory_allocated'] / 2**30:.2f} GiB")
        report("mamba stats: " + json.dumps(mstats))
        wall["mamba"] = time.perf_counter() - t0
    report("phase wall seconds: " + json.dumps(wall))

    if failures:
        for msg in failures:
            print(f"FAIL: {msg}", file=sys.stderr)
        return 1

    # the train phase's two runs (recompute, then spill) and the dp phase's
    # run are the training main paths
    tr = tstats.get("launches", {})
    ts = tstats.get("spill", {}).get("launches", {})
    td = dstats.get("launches", {})
    tl = {k: tr.get(k, 0) + ts.get(k, 0) + td.get(k, 0)
          for k in ("k1_fwd", "k1_bwd", "k2")}
    serve_k1 = stats.get("k1_launches", 0)
    kernels = [
        _kernel_entry("K1 flash_attention_fwd",
                      "src/repro_torch/csrc/flash_attention_fwd.cu",
                      "src/repro/kernels/flash_attention.py:27",
                      serve_k1 + tl["k1_fwd"], rows, HEADLINE, smi,
                      launches_by_path={
                          "serve": serve_k1,
                          "train_recompute": tr.get("k1_fwd", 0),
                          "train_spill": ts.get("k1_fwd", 0),
                          "train_dp": td.get("k1_fwd", 0)}),
        _kernel_entry("K1 flash_attention_bwd",
                      "src/repro_torch/csrc/flash_attention_bwd.cu",
                      "src/repro/models/attention.py:105",
                      tl["k1_bwd"], brows, K1B_HEADLINE, smi,
                      launches_by_path={
                          "train_recompute": tr.get("k1_bwd", 0),
                          "train_spill": ts.get("k1_bwd", 0),
                          "train_dp": td.get("k1_bwd", 0)}),
        _kernel_entry("K2 fused_adam", "src/repro_torch/csrc/fused_adam.cu",
                      "src/repro/kernels/fused_adam.py:27",
                      tl["k2"], arows, K2_HEADLINE, smi,
                      launches_by_path={
                          "train_recompute": tr.get("k2", 0),
                          "train_spill": ts.get("k2", 0),
                          "train_dp": td.get("k2", 0)}),
        _kernel_entry("K3 selective_scan_fwd",
                      "src/repro_torch/csrc/selective_scan.cu",
                      "src/repro/kernels/selective_scan.py:27",
                      mstats.get("k3_launches", 0), srows, K3_HEADLINE, smi,
                      library="none: no PyTorch call computes a selective "
                              "scan"),
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
