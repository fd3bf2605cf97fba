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
   required bit-identical; hd 32, 64, 128 and 256, MLA's q/k 192 with v
   128 and its smoke config's (48, 32); Sq != Skv: whisper-base's
   cross-attention of 448 decoder tokens, or 1 in decode, against 1500
   encoder frames, and its smoke config's 16 against 32; hd 80 refused;
   the library call is ``scaled_dot_product_attention`` timed
   on each backend that takes the inputs, the fastest reported by
   name), K2 fused Adam (also the
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

8. entry — the port's entry points through their own ``main(argv)``:
   (l) the training CLI (``repro_torch.launch.train``) in memory at
   GPT-100M full width and depth, ``ENTRY_STEPS`` steps of 16 x 256
   tokens, M 4, alpha 0.25: K1 forward launches == 2 L steps and
   backward == L steps (every layer runs under checkpoint), the mean of
   the last five losses below the first, s/step, tokens/s and
   ``max_memory_allocated``; (m) the CLI under ``--offload`` at
   GPT-100M, 3 steps at its defaults (f32 params, 4 x 2 x 128 tokens,
   alpha 0, ratios 0.5 / 0.5 / 0): bytes == plan_traffic x steps and the
   closed forms, losses within ``LOSS_RTOL`` of the in-memory oracle from
   the same seed-0 params and batches, K1 and K2 launches; (n) the
   gpt-tiny ``Trainer`` from f32 params on the card against the CPU
   (losses within ``TRAINER_LOSS_RTOL``: from its first update it trains
   bf16 params); (o) its checkpoint resume bitwise under
   deterministic algorithms; (p) the kernel benchmark
   (``repro_torch.bench.kernels``), every row within its tolerance; (q)
   the six examples (``repro_torch.examples``), each passing its own
   check.
9. archs — the attention architectures at full width: (r) gemma3-1b at
   full size through ``ServeEngine`` (bf16, half of params and KV on the
   SSD, prompts of 2048, 1000 and 512 tokens, 16 new tokens each, a
   preempt): the three-way KV byte invariant over its ring and global
   units, tokens equal to the in-memory B=1 decode, K1 launches == the
   layers that take K1 at each prompt's length (4 global, and the 22
   windowed ones when the prompt is no whole number of windows); (s)
   gemma3-1b trained through the CLI in memory (bf16, 4 x 2048 tokens,
   M 2, alpha 0.25): K1 launches of its 4 global layers (forward twice
   under checkpoint), finite falling losses; (t) deepseek-v2-lite-16b at
   full size in memory (27 layers, MLA through K1 at q/k 192 and v 128,
   MoE top-6 of 64 + 2 shared): a prefill of 2 x 1024 for the MoE drop
   count and 16 timed decode steps at capacity 1.25 (the decode rate),
   then at capacity factor E / K (no MoE drops) a prefill, 16 greedy
   decode steps into caches grown one slot a step (no step sees an empty
   slot), the last step's logits against a fresh prefill's, K1 launches
   == prefills x 27; (u) deepseek-v2-lite-16b trained at full width, 2
   layers (K1's backward at (192, 128)); (v) qwen3-moe-235b-a22b at full width, 2
   layers, as (t); (w) the seven SMOKE configs (whisper-base's and
   internvl2-76b's too) in f32 on the card against the CPU (a training
   step's loss and gradients, prefill and 4 decode steps) within 1e-5;
   (x) whisper-base at full size (6 + 6 layers, 1500 frames): trained
   through the CLI in memory (K1 launches derived from the plan: encoder,
   decoder self- and cross-attention, each under checkpoint), then a
   prefill of 2 x 4 tokens over 2 x 1500 frames and 32 greedy decode
   steps (K1 at Sq = 1 against 1500 in 6 layers a step) into caches grown
   a slot a step, the last step against a fresh prefill within 0.1
   relative; (y) internvl2-76b at full width (depth 80 -> 2: a prefill of
   256 image + 768 text positions, 16 decode steps, the same gate; depth
   1 for the Trainer, 4 steps of 2 x 1024).
10. hybrid — jamba-v0.1-52b (1 attention : 7 Mamba layers, MoE 16 x
   top-2 on every other layer) at full width: (z1) one 8-layer block (13.3
   B params, bf16) generating as (t): a prefill of 2 x 1024 (MoE drops at
   capacity 1.25), 16 timed decode steps and two under the profiler, then
   at capacity factor E / K a prefill, 16 decode steps into caches grown a
   slot a step (Mamba states copied whole) and a fresh prefill: K1
   launches == 3 prefills x 1 attention layer, K3 launches == 3 x 7 Mamba
   layers, the last step within 0.1 relative; (z2) 2 layers (Mamba + MLP,
   Mamba + MoE: 3.74 B params) through the ``Trainer``, bf16, 4 steps of
   2 x 1024, M 2: finite losses, the first batch's loss refit under the
   trained params below its step-1 loss, no kernel launched (training
   runs the model's chunked scan), one step profiled beside the chunked
   scan alone; (w) jamba-v0.1-52b's and falcon-mamba-7b's SMOKE configs
   in f32, card vs CPU: the training step's loss and gradients within
   1e-5, prefill and 4 decode steps' logits within 1e-4, each decode step
   from the CPU's caches.
11. mesh — the launch layer on MESH_RANKS = 4 ``torch.distributed``
   ranks on a 2 x 2 ("data", "model") mesh that share the card over gloo
   (NCCL refuses two ranks on one GPU), spawned once after the unsharded
   references ran here and freed the card (the ranks only load the
   kernels built here): (m1) deepseek-v2-lite-16b's MoE layer at full
   width, bf16, 4 x 1024 tokens, expert-parallel over "model" (32 experts
   a rank, the all-to-all dispatch): at capacity 8 against ``moe_apply``
   in one process (relative norm within REL_TOL, aux within 1e-5), EP
   dispatches on every rank, the drops at 1.25 reported; (m2)
   deepseek-v2-lite-16b at full width and 3 layers (1.670 B params),
   bf16, 4 x 1024 tokens, 1 Adam step, in the reference's baseline
   lowering (FSDP over "model", the batch over "data") and optimized
   lowering (``fully_shard``, the batch over every axis, EP, the
   activation spec and gradient shardings), each against the unsharded
   step from the same weights and batch: losses, grad norms, each leaf's
   update by relative norm (the baseline's; the optimized mode's in a
   third run at capacity 8 over 4 x 256 tokens, where nothing drops),
   each rank's collective calls and bytes by kind equal to their closed
   form from the spec tree, K1 launches on every rank; (m3)
   qwen3-moe-235b-a22b's SMOKE config, optimized, f32: the card's ranks
   against the same ranks on the CPU, loss and gradients within 1e-5.

Prints every measurement (``serve stats``, ``train stats``, ``dp stats``,
``mamba stats``, ``entry stats``, ``archs stats``, ``hybrid stats`` and
``mesh stats`` JSON lines, the autotuner's decision
log, a ``{"kernels": [...]}`` line with each kernel's numbers), the
``nvidia-smi`` name/power-limit line, and last ``{"ok": true, "device":
{...}}``.

    python3 chip_smoke.py                # what a check runs: all phases
    python3 chip_smoke.py --phases kernels
    python3 chip_smoke.py --phases dp
    python3 chip_smoke.py --phases mamba
    python3 chip_smoke.py --phases entry
    python3 chip_smoke.py --phases kernels,archs
    python3 chip_smoke.py --phases hybrid
    python3 chip_smoke.py --phases mesh
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
# the entry phase: the training CLI's in-memory run at GPT-100M (gate
# (l)); train_gpt100m runs at its default 200 steps in gate (q): at 20
# its own check (the loss falls by 1.0) failed on the card (10.7800 ->
# 10.7554), GPT-100M barely moves on the synthetic stream that early
ENTRY_STEPS = 30
# gate (n): the Trainer casts its params to bf16 at every update (alpha
# > 0: from the first step's flush), so the card and the CPU differ as
# bf16 products do; the engine tests' bf16 tolerance (measured on the
# card: 6.5e-5)
TRAINER_LOSS_RTOL = 2e-4
# (name, B, Hq, Hk, S, hd, dtype, causal, window, q0); S is one length
# or (Sq, Skv), hd one head dim or (q/k head dim, v head dim)
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
    # GPT-100M's training shape (the entry phase: 16 x 256 tokens)
    ("gpt-100m train S=256", 16, 12, 12, 256, 64, "bfloat16", True, None, 0),
    # the attention architectures (archs phase): gemma3-1b at hd 256 with
    # 4 q heads on 1 KV head, a global layer and a windowed prefill that
    # is no whole number of windows (K1 with the window); f32 at hd 256;
    # deepseek-v2-lite's MLA at q/k 192 with v 128, its smoke config's
    # (48, 32) in f32; starcoder2 (G = 9), qwen3-moe (G = 16) and phi3
    # (G = 4) at hd 128
    ("gemma3-1b global S=2048", 1, 4, 1, 2048, 256, "bfloat16", True, None,
     0),
    ("gemma3-1b local S=1000 window 512", 1, 4, 1, 1000, 256, "bfloat16",
     True, 512, 0),
    ("f32 hd256 gqa ragged window q0", 1, 4, 1, 200, 256, "float32", True,
     48, 16),
    ("f32 hd256 non-causal ragged", 2, 4, 2, 77, 256, "float32", False,
     None, 0),
    ("deepseek-v2-lite mla S=2048", 1, 16, 16, 2048, (192, 128), "bfloat16",
     True, None, 0),
    ("deepseek-v2-lite mla S=1000", 1, 16, 16, 1000, (192, 128), "bfloat16",
     True, None, 0),
    ("f32 mla (192,128) ragged window q0", 1, 4, 4, 200, (192, 128),
     "float32", True, 48, 16),
    ("deepseek-v2-lite-smoke mla f32 (48,32)", 2, 4, 4, 64, (48, 32),
     "float32", True, None, 0),
    ("deepseek-v2-lite-smoke mla (48,32)", 2, 4, 4, 64, (48, 32),
     "bfloat16", True, None, 0),
    ("starcoder2-7b S=2048 G=9", 1, 36, 4, 2048, 128, "bfloat16", True, None,
     0),
    ("qwen3-moe S=1024 G=16", 1, 64, 4, 1024, 128, "bfloat16", True, None,
     0),
    ("phi3-medium-14b S=2048 G=4", 1, 40, 10, 2048, 128, "bfloat16", True,
     None, 0),
    # the encoder-decoder and VLM families (archs phase, gates (x), (y)):
    # whisper-base's encoder over its 1500 frames (non-causal; 1500 = 11 x
    # 128 + 92 keys, a ragged last tile), its decoder's causal
    # self-attention at 448 and cross-attention of 448 decoder tokens
    # against the 1500 frames (Sq != Skv), decode's cross-attention at
    # Sq = 1 (one valid row of a 128-row Q tile). In bf16 training the
    # encoder's activations are f32 (the frame embeddings are, and bf16
    # weights promote, as in the reference), so the encoder and cross rows
    # run in f32 on the main path, and in bf16 here too. whisper-base-smoke
    # (hd 32, F = 32) in f32; internvl2's 64:8 group at hd 128 over 256
    # image + 768 text tokens
    ("whisper-base encoder S=1500", 4, 8, 8, 1500, 64, "bfloat16", False,
     None, 0),
    ("whisper-base encoder f32 S=1500", 4, 8, 8, 1500, 64, "float32", False,
     None, 0),
    ("whisper-base decoder S=448", 4, 8, 8, 448, 64, "bfloat16", True, None,
     0),
    ("whisper-base cross Sq=448 Skv=1500", 4, 8, 8, (448, 1500), 64,
     "bfloat16", False, None, 0),
    ("whisper-base cross f32 Sq=448 Skv=1500", 4, 8, 8, (448, 1500), 64,
     "float32", False, None, 0),
    ("whisper-base decode cross Sq=1 Skv=1500", 2, 8, 8, (1, 1500), 64,
     "bfloat16", False, None, 0),
    ("whisper-base-smoke cross f32 Sq=16 Skv=32", 2, 4, 4, (16, 32), 32,
     "float32", False, None, 0),
    ("internvl2-76b S=1024 G=8", 1, 64, 8, 1024, 128, "bfloat16", True, None,
     0),
    # the hybrid family (gate (z1)): jamba-v0.1-52b's attention layer in a
    # prefill of 2 x 1024 tokens, 32 q heads on 8 KV heads at hd 128
    ("jamba-v0.1-52b S=1024 G=4", 2, 32, 8, 1024, 128, "bfloat16", True,
     None, 0),
]
#: (q/k, v) head dims K1 must refuse with ValueError, per dtype
K1_REFUSED = [((80, 80), "bfloat16"), ((80, 80), "float32")]
HEADLINE = "gpt-65b prefill S=2048"

# K1 backward: (name, B, Hq, Hk, S, hd, dtype, causal, window); S and hd
# as in K1_SHAPES
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
    ("gpt-100m train S=256", 16, 12, 12, 256, 64, "bfloat16", True, None),
    # the attention architectures, as in K1_SHAPES: gemma3-1b trains its 4
    # global layers through K1 (its local layers take the banded form at
    # S = 2048); deepseek-v2-lite's MLA; the GQA groups of 9, 16 and 4
    ("gemma3-1b global S=2048", 1, 4, 1, 2048, 256, "bfloat16", True, None),
    ("gemma3-1b local S=1000 window 512", 1, 4, 1, 1000, 256, "bfloat16",
     True, 512),
    ("f32 hd256 gqa ragged window", 1, 4, 1, 200, 256, "float32", True, 48),
    ("deepseek-v2-lite mla S=2048", 1, 16, 16, 2048, (192, 128), "bfloat16",
     True, None),
    ("deepseek-v2-lite mla S=1000", 1, 16, 16, 1000, (192, 128), "bfloat16",
     True, None),
    ("f32 mla (192,128) ragged window", 1, 4, 4, 200, (192, 128), "float32",
     True, 48),
    ("deepseek-v2-lite-smoke mla f32 (48,32)", 2, 4, 4, 64, (48, 32),
     "float32", True, None),
    ("deepseek-v2-lite-smoke mla (48,32)", 2, 4, 4, 64, (48, 32),
     "bfloat16", True, None),
    ("starcoder2-7b S=2048 G=9", 1, 36, 4, 2048, 128, "bfloat16", True,
     None),
    ("qwen3-moe S=1024 G=16", 1, 64, 4, 1024, 128, "bfloat16", True, None),
    ("phi3-medium-14b S=2048 G=4", 1, 40, 10, 2048, 128, "bfloat16", True,
     None),
    # the encoder-decoder and VLM families, as in K1_SHAPES (decode has no
    # backward): the dK/dV pass walks 7 Q tiles of 64 rows over 24 key
    # tiles, the last holding 1500 - 23 x 64 = 28 keys
    ("whisper-base encoder S=1500", 4, 8, 8, 1500, 64, "bfloat16", False,
     None),
    ("whisper-base encoder f32 S=1500", 4, 8, 8, 1500, 64, "float32", False,
     None),
    ("whisper-base decoder S=448", 4, 8, 8, 448, 64, "bfloat16", True, None),
    ("whisper-base cross Sq=448 Skv=1500", 4, 8, 8, (448, 1500), 64,
     "bfloat16", False, None),
    ("whisper-base cross f32 Sq=448 Skv=1500", 4, 8, 8, (448, 1500), 64,
     "float32", False, None),
    ("whisper-base-smoke cross f32 Sq=16 Skv=32", 2, 4, 4, (16, 32), 32,
     "float32", False, None),
    ("internvl2-76b S=1024 G=8", 1, 64, 8, 1024, 128, "bfloat16", True,
     None),
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
    # the hybrid family: jamba-v0.1-52b's prefill in gate (z1) (d_inner
    # 8192, state 16, dt_rank 256 as falcon-mamba's), its SMOKE config's in
    # gate (w) (dt_rank 16)
    ("jamba-v0.1-52b prefill B=2 S=1024", 2, 1024, 8192, 16, "bfloat16",
     K3_DT_RANK),
    ("jamba-v0.1-52b-smoke f32 (2,40,512,8)", 2, 40, 512, 8, "float32", 16),
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
# (the archs phase) gemma3-1b served at full size (26 layers: 22 with a
# 512-token window, 4 global) with prompts of 2048 and 512 tokens (the
# banded form in local layers) and 1000 (K1 with the window, the ring
# written at the clamped start), 16 new tokens each
ARCHS_SERVE_PROMPTS, ARCHS_GEN = (2048, 1000, 512), 16
# gemma3-1b trained in memory through the CLI at full size, bf16
GEMMA_TRAIN_STEPS, GEMMA_TRAIN_B, GEMMA_TRAIN_S = 6, 4, 2048
# deepseek-v2-lite-16b at full size in memory (27 layers, 15.7 B params),
# and qwen3-moe-235b-a22b at full width with depth cut to 2 layers (a
# full-depth stack is ~470 GB of bf16): 2 prompts of 1024 tokens. First
# the plain generation at the reference's capacity factor 1.25: a prefill
# (its MoE drop count) and 16 greedy decode steps into caches of prompt +
# 16 slots, each step timed alone (the decode rate), then two steps more
# under ``torch.profiler`` (the card's busy share). Then the gate: a
# prefill, 16 greedy decode steps and a fresh prefill over prompt +
# generated tokens, with the blocks' MoE at capacity factor E / K (C = T:
# ``moe_ep.moe_dispatch`` replaced for the gate's scope). The gate's caches
# hold exactly the positions written so far: the prompt's, then one slot
# more before each decode step (``grow_caches``), so no step sees an empty
# slot (the reference's decode lets empty slots into the softmax,
# ROADMAP.md section 3: with caches of prompt + 16 slots from the start,
# the early steps' empty slots shift what they write into the deeper
# layers' caches, and the last step parts from the prefill by 1.2e-2 in
# f32 at SMOKE size, against 3e-6 grown); and no MoE assignment drops (at
# 1.25 a decode step of T = 2 tokens and a prefill of T = 2080 drop
# different assignments: measured rel 0.30 on deepseek-v2-lite and 0.75
# on qwen3-moe). So the last step's logits can be held against the fresh
# prefill's last logits
MOE_B, MOE_S, MOE_GEN = 2, 1024, 16
QWEN_MOE_LAYERS = 2
# last decode step vs fresh prefill, ||decode - prefill|| / ||prefill||:
# the decode attends in f32 (MLA: absorbed, over the bf16 latent cache),
# the prefill through K1 in bf16, and each layer's output is rounded to
# bf16 before the next; a token whose router probabilities tie within
# that rounding can also take another expert. A cache fault (a slot
# written at the wrong position, a lost row) moves the logits by the
# order of their own norm
LAST_STEP_REL_TOL = 0.1
# deepseek-v2-lite-16b trained through the Trainer at full width, depth
# cut to its dense prefix layer and one MoE layer (K1's backward at q/k
# 192, v 128), bf16
DS_TRAIN_LAYERS, DS_TRAIN_STEPS, DS_TRAIN_B, DS_TRAIN_S = 2, 6, 4, 1024
# the five SMOKE configs in f32, card against CPU: one training step's
# loss and gradients, prefill and 4 decode steps' logits. Both sides run
# the same f32 math (K1 on the card, its plain version on the CPU), so
# they differ by the order of f32 sums; weight gradients (sums over
# every token) are held at this tolerance times their leaf's largest
# element
ARCHS_SMOKE_TOL = 1e-5
# (w) also runs deepseek-v2-lite-smoke in bf16 (its MLA through K1 at
# q/k 48, v 32 both ways), card against CPU: the training step's loss
# within the MoE stacks' bf16 tolerance of tests/test_torch_archs.py (a
# token whose router probabilities tie within bf16 rounding can take
# another expert on each side); gradients and logits are reported
ARCHS_SMOKE_BF16 = "deepseek-v2-lite-16b"
ARCHS_SMOKE_BF16_RTOL = 2e-3
SMOKE_ARCHS = ("phi3-medium-14b", "starcoder2-7b", "gemma3-1b",
               "deepseek-v2-lite-16b", "qwen3-moe-235b-a22b", "whisper-base",
               "internvl2-76b")
# (x) whisper-base (arXiv:2212.04356) at full size: 6 encoder + 6 decoder
# layers, d_model 512, 97.3 M params, its published 1500 encoder frames
# (n_audio_ctx) and 448 decoder positions (n_text_ctx). Trained through
# the CLI in memory, bf16, 4 x 448 tokens over 4 x 1500 x 512 frame
# embeddings (f32, as the reference's batches make them, so the encoder
# computes in f32), M 2, alpha 0.25; served in memory: a prefill of 2 x 4
# decoder tokens over 2 x 1500 frames, then greedy decode steps into
# caches grown a slot a step (the cross-attention cache holds the 1500
# frames' K/V from the prefill)
WHISPER_TRAIN_STEPS, WHISPER_TRAIN_B, WHISPER_TRAIN_S = 6, 4, 448
WHISPER_B, WHISPER_PROMPT, WHISPER_GEN = 2, 4, 32
# (y) internvl2-76b (arXiv:2404.16821; its Llama-3-70B-shaped backbone,
# the InternViT tower stubbed by 256 image embeddings) at full width,
# depth cut 80 -> 2 for the generation (3.81 B params, 7.6 GB of bf16;
# the full stack's 70.6 B params do not fit one card): 1 x (256 image +
# 768 text) prefill, 16 greedy decode steps, grown caches. Trained
# through the Trainer at 1 layer (2.96 B params), bf16, alpha 0, 4 steps
# of 2 x 1024 positions, M 2. Memory: bf16 params 5.9 GB, f32 masters +
# m + v 35.5 GB, bf16 gradients 5.9 GB, the next step's bf16 params 5.9
# GB and the f32 temporaries of one update piece (the Adam update goes
# 64 M elements at a time: whole, the 1.05 B-param embedding's took ~7 x
# 4.2 GB and ran the card out of memory) ~55 GB; at 2 layers the f32
# state alone is ~46 GB, and alpha > 0 would add an f32 copy of every
# gradient (11.8 GB)
VLM_LAYERS, VLM_TEXT, VLM_GEN = 2, 768, 16
VLM_TRAIN_LAYERS, VLM_TRAIN_STEPS, VLM_TRAIN_B, VLM_TRAIN_S = 1, 4, 2, 1024
# (the hybrid phase) jamba-v0.1-52b (arXiv:2403.19887) at full width. (z1)
# the generation over one 8-layer block, depth cut 32 -> 8 (13.30 B params,
# 26.6 GB of bf16; the whole stack's 51.6 B, ~103 GB, do not fit one card):
# Mamba + MLP, Mamba + MoE, Mamba + MLP, GQA 32:8 + MoE as the prefix, then
# (Mamba + MLP, Mamba + MoE) x 2, through ``moe_generate`` as (t) and (v):
# K1 in the attention layer's prefills, K3 in the 7 Mamba layers', the last
# decode step against a fresh prefill within LAST_STEP_REL_TOL (the MoE
# gates' 0.1, written into PERF.md before the first card run: falcon-mamba's
# healthy decode-vs-prefill gaps are 0.027 / 0.069 over 64 Mamba layers,
# and here 7 carry 16 steps). The gate runs in f32 (26.6 GB of bf16 params
# freed, the same seed's 53.2 GB of f32 made): in bf16 a decoded token
# whose top-2 router choice ties within the rounding of the decode's and
# the prefill's paths takes other experts in one of them, and that step's
# logits part by up to 0.59 (an H100, 16 steps: 0.025-0.03 between such
# flips, 0.146 at the last; with dense MLPs in place of the MoE a flat
# 0.024-0.029; in f32 0.0044-0.0060). (z2) the Trainer at depth 2 (Mamba + MLP,
# Mamba + MoE of 16 experts: 3.74 B params), bf16, alpha 0, 4 steps of
# 2 x 1024 tokens, M 2, lr 1e-4, as (y): at (y)'s 18.9 B a param ~66 GiB;
# alpha > 0 would add an f32 copy of every gradient (~15 GB)
JAMBA_GEN_LAYERS = 8
JAMBA_TRAIN_LAYERS, JAMBA_TRAIN_STEPS, JAMBA_TRAIN_B, JAMBA_TRAIN_S = \
    2, 4, 2, 1024
JAMBA_TRAIN_M = 2
# gate (w)'s Mamba stacks, run in the hybrid phase: the training step is
# the Mamba training check on the card (the model's chunked scan under
# autograd, K1's backward at hd 32 in Jamba's attention layer)
HYBRID_SMOKE_ARCHS = ("jamba-v0.1-52b", "falcon-mamba-7b")
# the mesh phase: MESH_RANKS torch.distributed ranks on a 2 x 2 ("data",
# "model") mesh, all on the one card, joined over gloo (NCCL refuses two
# ranks on one GPU; tools/gloo_cuda_probe.py: gloo takes CUDA tensors for
# every collective the port uses). A rank that fails, or ranks still
# running after MESH_TIMEOUT seconds, fail the phase.
MESH_RANKS, MESH_SHAPE, MESH_BACKEND, MESH_TIMEOUT = 4, (2, 2), "gloo", 400
# (m1) deepseek-v2-lite-16b's MoE at full width (d 2048, 64 routed experts
# + 2 shared, top-6, moe_d_ff 1408), bf16, 4 x 1024 tokens, EP over
# "model" (32 experts a rank): at capacity 8 (nothing drops on either side)
# against moe_apply in one process at the kernels' bf16 relative-norm
# bound (the experts' products run at other row counts, so cuBLAS may
# round otherwise) and the aux loss within 1e-5 (the f32 router on the
# same bf16 tokens); at 1.25 the drops are reported
M1_B, M1_S, M1_CAPS = 4, 1024, (8.0, 1.25)
M1_REL_TOL, M1_AUX_TOL = REL_TOL, 1e-5
# (m2) deepseek-v2-lite-16b at full width, depth 27 -> 3 (the dense first
# layer + 2 stacked MoE periods, ~1.67 B params), bf16, 4 x 1024 tokens,
# M2_STEPS Adam step at lr M2_LR, in both of the reference's lowerings,
# against the unsharded step from the same weights and batch. Tolerances:
# the baseline computes the unsharded step's math (the MoE over the
# gathered global batch) in another order, so losses within 1e-2 and
# grad norms within 5e-2 relative, as bf16 rounding moves them; the
# optimized mode at capacity 1.25 drops other assignments (EP's capacity
# is per owner shard and local expert), so the reference's own 2 % and
# 10 % (tests/test_optimized_sharding.py). The updates: each leaf's
# update (f32 master less the initial params) against the unsharded
# step's by relative norm, within M2_UPDATE_RTOL. Adam's first updates
# are about lr sign(g), so bf16 rounding that flips the sign of a small
# gradient moves it: 0.03-0.19 on the SMOKE configs' leaves on CPU ranks.
# The controls it fails: no update reads 1; the unsharded step on half
# the batch reads 0.71-0.93 there, and the phase measures it again on
# the card (its least leaf must stay above the limit). At capacity 1.25
# the optimized mode's experts see other drops (0.58 on qwen3-moe's
# SMOKE leaves), so its update is held in a third run, the optimized
# mode at capacity M2_EXACT_CF (nothing drops on either side: both
# counts must be 0), against the unsharded step at that capacity, at the
# baseline's limits. Its sequences are cut to M2_EXACT_S tokens: EP's
# second capacity grows as the square of the factor, and at capacity 8
# over 1024 tokens the four ranks' expert buffers took the H100 past its
# 80 GB. One step a run, not two: with two steps a mode and the third
# run the phase took 208 s on the H100 against the 150 s it may take,
# and the update gates hold the first step's update.
M2_LAYERS, M2_B, M2_S, M2_STEPS, M2_LR = 3, 4, 1024, 1, 1e-4
M2_LOSS_RTOL = {"baseline": 1e-2, "optimized": 2e-2, "exact": 1e-2}
M2_GN_RTOL = {"baseline": 5e-2, "optimized": 0.1, "exact": 5e-2}
M2_UPDATE_RTOL = 0.4
M2_EXACT_CF, M2_EXACT_S = 8.0, 256
# (m3) qwen3-moe-235b-a22b's SMOKE config, optimized mode (EP), f32, 8 x 32
# tokens: the card's ranks against the same ranks on the CPU (ranks keep
# one thread), a step's loss and gradients within 1e-5 (gradients of each
# leaf's largest element)
M3_ARCH, M3_B, M3_S, M3_TOL = "qwen3-moe-235b-a22b", 8, 32, 1e-5
# (m4) sharded serving (the reference's lower_prefill / lower_decode
# layout: parameters over "model" gathered at use, the batch over "data",
# caches by cache_pspec): deepseek-v2-lite-16b at (m2)'s width, depth and
# seed, bf16, a prefill of M4_B x M4_S tokens and M4_GEN decode steps of
# fixed tokens into caches of M4_S + M4_GEN slots (the MLA latent and rope
# keys split over "model"), against the unsharded prefill / decode_step on
# the card from the same weights and tokens: every call's logits within
# SERVE_REL_TOL by relative norm (bf16: the ranks' products run over half
# the rows, so cuBLAS may round otherwise). The MoE runs at capacity
# factor E / K (C = T, nothing drops on either side): at 1.25 a decode
# step's T = 4 tokens fit one slot an expert, and which assignment drops
# follows bf16 ties. Each rank's K1 launches == layers x 1 prefill (decode
# is the absorbed MLA, no K1); every rank's collective counts == their
# closed form (sharded.serve_collectives) in every call.
M4_B, M4_S, M4_GEN = 4, 512, 4
SERVE_REL_TOL = 1e-2
# (m5) qwen3-4b at full width, depth 36 -> M5_LAYERS, bf16, K/V split over
# "model" (K1 at hd 128, G = 4), as (m4)
M5_LAYERS, M5_SEED = 2, 5
# (m6) SMOKE configs in f32: the card's ranks against the same ranks on
# the CPU, every call's logits within M6_TOL of the CPU's largest (1e-4
# for the Mamba families, gate (w)'s card-vs-CPU limit); a prefill of
# M6_B x M6_S (gemma3's ring of 16 slots written at the clamped start)
# and M6_GEN decode steps. Each Mamba decode step starts from the CPU
# ranks' conv tails (sharded.decode_job's "conv_from"): a tail is bf16
# and can round the other way on the card, which alone moves the logits
# by up to 1.7e-4 of their largest (measured on the CPU, one ulp).
M6_ARCHS = ("falcon-mamba-7b", "jamba-v0.1-52b", "gemma3-1b", "whisper-base")
M6_B, M6_S, M6_GEN, M6_CACHE = 4, 25, 4, 32
M6_TOL = {"ssm": 1e-4, "hybrid": 1e-4}
M6_TOL_DEFAULT = 1e-5
# (d) the dry-run (launch/dryrun.py) in a spawned child, as rank 0 of a
# fake world: (m2)'s configuration at 2 x 2 in both lowerings, whose
# collective counts must equal what (m2)'s rank 0 counted; and
# deepseek-v2-lite-16b train_4k at 16 x 16, printed
D_FULL = ("deepseek-v2-lite-16b", "train_4k")
# the phase's predicted wall time: three unsharded references ~25 s, two
# updates to disk ~10 s, 4 ranks up ~10 s, (m2) one step a run: ~30 s
# baseline, ~20 s optimized, ~20 s the exact run (gloo moves ~5 GB a
# rank a step), (m1) + (m3) ~10 s; (m4) ~15 s (every call gathers the
# 3.3 GB of params through gloo: ~1.7 GB a rank a call), (m5) ~8 s, (m6)
# ~5 s, their references ~5 s; (d) overlaps the rest in its own process
MESH_PREDICTED_S = 160.0


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


def head_dims(hd):
    """(q/k head dim, v head dim) of a shape row's ``hd``."""
    return tuple(hd) if isinstance(hd, tuple) else (hd, hd)


def seq_lens(S):
    """(Sq, Skv) of a shape row's ``S``."""
    return tuple(S) if isinstance(S, tuple) else (S, S)


def plain_chunks(S):
    """K1's plain versions' chunk sizes for a row (``fa.plain_chunks``)."""
    from repro_torch.kernels import flash_attention as fa
    return fa.plain_chunks(*seq_lens(S))


def sdpa_backends(torch, q, k, v, causal, window=None):
    """``scaled_dot_product_attention`` computing K1's function on these
    inputs (k and v with q's heads: GQA's KV heads repeated by the caller;
    a window as a boolean mask), once per backend that takes them.
    Returns [(backend name, fn)]: ``fn(q, k, v)`` is one call pinned to
    that backend."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    mask = None
    if window is not None:
        i = torch.arange(q.shape[2], device=q.device)
        d = i[:, None] - i[None, :]
        mask = d < window
        if causal:
            mask &= d >= 0
    out = []
    for b in (SDPBackend.FLASH_ATTENTION, SDPBackend.CUDNN_ATTENTION,
              SDPBackend.EFFICIENT_ATTENTION, SDPBackend.MATH):
        def fn(qq, kk, vv, b=b):
            with sdpa_kernel([b]):
                return F.scaled_dot_product_attention(
                    qq, kk, vv, attn_mask=mask,
                    is_causal=causal and mask is None)
        try:
            fn(q, k, v)
            torch.cuda.synchronize()
        except RuntimeError:
            continue
        out.append((b.name, fn))
    if not out:
        raise RuntimeError("no scaled_dot_product_attention backend took "
                           "the inputs")
    return out


def fastest(times: dict):
    """(name, ms) of the fastest entry of ``{name: ms}``."""
    name = min(times, key=times.get)
    return name, times[name]


def k1_work(B, Hq, Hk, S, hd, dtype, causal, window, q0):
    """(bytes, flops) K1 needs on these inputs: q, k, v read once, out and
    lse written once; 2*(hd_qk + hd_v) FLOP (QK^T and PV) per admitted
    (query, key) pair, counted for this mask (top-left at Sq != Skv)."""
    hq, hv = head_dims(hd)
    sq, skv = seq_lens(S)
    item = 2 if dtype == "bfloat16" else 4
    nbytes = item * (B * Hq * sq * (hq + hv) + B * Hk * skv * (hq + hv)) \
        + 4 * B * Hq * sq
    pairs = 0
    for i in range(sq):
        p = q0 + i
        lo = 0 if window is None else max(0, p - window + 1)
        hi = min(skv - 1, p) if causal else skv - 1
        pairs += max(0, hi - lo + 1)
    return nbytes, 2 * (hq + hv) * pairs * B * Hq


def k1_refusals(torch, fa):
    """Failures: a (q/k, v) head-dim pair of K1_REFUSED that K1 launched
    instead of raising ValueError."""
    failures = []
    for (hq, hv), dts in K1_REFUSED:
        dt = getattr(torch, dts)
        q = torch.zeros(1, 2, 64, hq, device="cuda", dtype=dt)
        v = torch.zeros(1, 2, 64, hv, device="cuda", dtype=dt)
        try:
            fa.flash_attention_fwd(q, q, v)
            failures.append(f"K1 took head dims ({hq}, {hv}) {dts}")
        except ValueError:
            pass
    return failures


def phase_kernels(torch, fa, report):
    rows = []
    for (name, B, Hq, Hk, S, hd, dts, causal, window, q0) in K1_SHAPES:
        dt = getattr(torch, dts)
        hq, hv = head_dims(hd)
        sq, skv = seq_lens(S)
        g = torch.Generator(device="cuda").manual_seed(len(rows))
        q = torch.randn(B, Hq, sq, hq, device="cuda", generator=g).to(dt)
        k = torch.randn(B, Hk, skv, hq, device="cuda", generator=g).to(dt)
        v = torch.randn(B, Hk, skv, hv, device="cuda", generator=g).to(dt)
        kw = dict(causal=causal, window=window, q0=q0)
        out, lse = fa.flash_attention_fwd(q, k, v, **kw)
        torch.cuda.synchronize()
        ref, ref_lse = fa.flash_attention_plain(q, k, v, **kw,
                                                **plain_chunks(S))
        diff = (out.float() - ref.float()).abs()
        err = diff.max().item()
        rel_err = (diff.norm() / ref.float().norm()).item()
        lse_err = (lse - ref_lse).abs().max().item()
        tol = TOL[dts]          # elementwise atol = rtol = tol
        ok = (bool(torch.isfinite(out.float()).all())
              and bool((diff <= tol + tol * ref.float().abs()).all())
              and rel_err <= REL_TOL and lse_err <= 1e-3)
        reps = 20 if max(sq, skv) >= 1024 else 50
        ms = cuda_ms(lambda: fa.flash_attention_fwd(q, k, v, **kw), reps)
        plain_ms = cuda_ms(lambda: fa.flash_attention_plain(
            q, k, v, **kw, **plain_chunks(S)), max(3, reps // 5), warmup=1)
        lib_ms = backend = None
        lib_all = {}
        if q0 == 0:
            G = Hq // Hk
            kr = k.repeat_interleave(G, dim=1)
            vr = v.repeat_interleave(G, dim=1)
            for bname, fn in sdpa_backends(torch, q, kr, vr, causal, window):
                lib_all[bname] = cuda_ms(lambda: fn(q, kr, vr), reps)
            backend, lib_ms = fastest(lib_all)
            del kr, vr
        nbytes, flops = k1_work(B, Hq, Hk, S, hd, dts, causal, window, q0)
        t_bytes = nbytes / PEAK_BYTES_S * 1e3
        t_ops = flops / PEAK_FLOPS[dts] * 1e3
        row = {"shape": name, "q": [B, Hq, sq, hq], "v_head_dim": hv,
               "kv_heads": Hk, "kv_len": skv,
               "dtype": dts, "causal": causal, "window": window, "q0": q0,
               "max_abs_err": err, "rel_err": rel_err,
               "lse_max_abs_err": lse_err, "tol": TOL[dts],
               "rel_tol": REL_TOL, "ok": ok, "ms": ms, "plain_ms": plain_ms,
               "library_ms": lib_ms, "library": backend,
               "library_ms_by_backend": lib_all,
               "bound_ms": max(t_bytes, t_ops),
               "bound_by": "operations" if t_ops >= t_bytes else "bytes",
               "tflops": flops / (ms * 1e-3) / 1e12}
        rows.append(row)
        report(f"K1 {name}: err {err:.3e} (tol {TOL[dts]}) rel_err "
               f"{rel_err:.3e} (tol {REL_TOL}) lse_err "
               f"{lse_err:.3e} | kernel {ms:.4f} ms ({row['tflops']:.2f} "
               f"TFLOP/s) plain {plain_ms:.4f} ms sdpa {lib_ms} ms "
               f"({backend}) bound "
               f"{row['bound_ms']:.4f} ms ({row['bound_by']}) -> "
               f"{'OK' if ok else 'FAIL'}")
        del q, k, v, out, lse, ref, ref_lse
    torch.cuda.empty_cache()
    return rows


def k1_bwd_work(B, Hq, Hk, S, hd, dtype, causal, window):
    """(bytes, flops) K1's backward needs on these inputs: q, k, v, out,
    dO and lse read once, dq, dk, dv written once; five products per
    admitted pair, of 2*hd_qk FLOP (QK^T, dS K, dS^T Q) or 2*hd_v (dO V^T,
    P^T dO)."""
    hq, hv = head_dims(hd)
    sq, skv = seq_lens(S)
    item = 2 if dtype == "bfloat16" else 4
    nbytes = item * (2 * B * Hq * sq * (hq + hv) + 2 * B * Hk * skv
                     * (hq + hv)) + 4 * B * Hq * sq
    _, fwd_flops = k1_work(B, Hq, Hk, S, hd, dtype, causal, window, 0)
    pair_flops = fwd_flops // (2 * (hq + hv))
    return nbytes, pair_flops * 2 * (3 * hq + 2 * hv)


def phase_k1_bwd(torch, fa, report):
    rows = []
    for (name, B, Hq, Hk, S, hd, dts, causal, window) in K1B_SHAPES:
        dt = getattr(torch, dts)
        hq, hv = head_dims(hd)
        sq, skv = seq_lens(S)
        g = torch.Generator(device="cuda").manual_seed(100 + len(rows))
        q = torch.randn(B, Hq, sq, hq, device="cuda", generator=g).to(dt)
        do = torch.randn(B, Hq, sq, hv, device="cuda", generator=g).to(dt)
        k = torch.randn(B, Hk, skv, hq, device="cuda", generator=g).to(dt)
        v = torch.randn(B, Hk, skv, hv, device="cuda", generator=g).to(dt)
        kw = dict(causal=causal, window=window)
        out, lse = fa.flash_attention_fwd(q, k, v, **kw)
        got = fa.flash_attention_bwd(q, k, v, out, do, lse, **kw)
        again = fa.flash_attention_bwd(q, k, v, out, do, lse, **kw)
        torch.cuda.synchronize()
        want = fa.flash_attention_bwd_plain(q, k, v, out, do, lse, **kw,
                                            **plain_chunks(S))
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
        reps = 5 if max(sq, skv) >= 1024 else 20
        ms = cuda_ms(lambda: fa.flash_attention_bwd(q, k, v, out, do, lse,
                                                    **kw), reps)
        plain_ms = cuda_ms(lambda: fa.flash_attention_bwd_plain(
            q, k, v, out, do, lse, **kw, **plain_chunks(S)), 2, warmup=1)
        G = Hq // Hk
        qr = q.detach().requires_grad_()
        kr = k.repeat_interleave(G, dim=1).detach().requires_grad_()
        vr = v.repeat_interleave(G, dim=1).detach().requires_grad_()
        lib_all = {}
        for bname, fn in sdpa_backends(torch, qr, kr, vr, causal, window):
            o = fn(qr, kr, vr)
            lib_all[bname] = cuda_ms(lambda: torch.autograd.grad(
                o, (qr, kr, vr), do, retain_graph=True), reps)
            del o
        backend, lib_ms = fastest(lib_all)
        del qr, kr, vr
        nbytes, flops = k1_bwd_work(B, Hq, Hk, S, hd, dts, causal, window)
        t_bytes = nbytes / PEAK_BYTES_S * 1e3
        t_ops = flops / PEAK_FLOPS[dts] * 1e3
        row = {"shape": name, "q": [B, Hq, sq, hq], "v_head_dim": hv,
               "kv_heads": Hk, "kv_len": skv,
               "dtype": dts, "causal": causal, "window": window,
               "max_abs_err": err, "rel_err": rel_err, "tol": tol,
               "rel_tol": REL_TOL, "deterministic": deterministic,
               "ok": ok, "ms": ms, "plain_ms": plain_ms,
               "library_ms": lib_ms, "library": backend,
               "library_ms_by_backend": lib_all,
               "bound_ms": max(t_bytes, t_ops),
               "bound_by": "operations" if t_ops >= t_bytes else "bytes",
               "tflops": flops / (ms * 1e-3) / 1e12}
        rows.append(row)
        report(f"K1 bwd {name}: err {err:.3e} (tol {tol}) rel_err "
               f"{rel_err:.3e} (tol {REL_TOL}) deterministic "
               f"{deterministic} | kernel {ms:.4f} ms ({row['tflops']:.2f} "
               f"TFLOP/s) plain {plain_ms:.4f} ms sdpa-bwd {lib_ms} ms "
               f"({backend}) "
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


def k1_layers(cfg, S: int) -> int:
    """Layers whose prefill (or training forward) of S tokens goes through
    K1: every global layer, and a windowed layer unless S is a whole
    number of windows (then it takes the banded form, as the reference
    dispatches it)."""
    from repro_torch.models import blocks as blk
    return sum(1 for k in blk.build_plan(cfg).all_kinds()
               if k.window is None or S % k.window or S < k.window)


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
        want_k1 = 0
        t_run = time.perf_counter()
        step_s = []
        while eng.pending():
            ts = time.perf_counter()
            dec = eng.step()
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - ts)
            prefills += len(dec["admitted"])
            want_k1 += sum(k1_layers(cfg, len(eng.requests[r].prompt))
                           for r in dec["admitted"])
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
    if k1_launches != want_k1:
        failures.append(f"K1 launches {k1_launches} != {want_k1}: the "
                        f"layers that take K1 over {prefills} prefills")
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
        "k1_launches_want": want_k1,
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
        # CPU-Adam busy seconds: the optimizer coordinators' own counters
        adam_s = [rk.opt_c.adam_busy_s for rk in stacks]
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
    """The port's in-memory vertical train step (``make_train_step``'s
    gradients and Adam update) from ``params`` over ``batches``: the
    per-step losses the offloaded runs are held to. The updated params
    are cast to the embedding's dtype: bf16 (as ``make_train_step``) for
    the bf16 runs, f32 for an f32 engine, which keeps its params f32."""
    from repro_torch.core import ScheduleConfig, grads_fn, init_train_state
    from repro_torch.optim import AdamConfig, apply_update
    gfn = grads_fn(cfg, ScheduleConfig(schedule="vertical",
                                       num_microbatches=TRAIN_M))
    dtype = params["embed"].dtype
    _, opt = init_train_state(cfg, params=params)
    p, out = params, []
    for b in batches:
        loss, grads = gfn(p, {"tokens": torch.from_numpy(b).cuda()})
        p, opt = apply_update(opt, grads, AdamConfig(lr=lr),
                              compute_dtype=dtype)
        out.append(float(loss))
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


def trainer_tiny_gates(torch, report, workroot):
    """Gates (n) and (o), gpt-tiny (seed 1 f32 params), vertical, M 4,
    alpha 0.25, 8 x 64 tokens a step: (n) 4 ``Trainer`` steps on the card
    against the same on the CPU (the kernels' plain versions): losses
    within ``TRAINER_LOSS_RTOL``, and the final f32 masters' largest
    difference reported; (o) under deterministic algorithms, 4 steps on
    the card against 2 steps, ``train.checkpoint.save``, ``restore``
    into a fresh Trainer (its data stream advanced past the batches
    drawn), 2 more: losses and every param and optimizer leaf bitwise.
    Returns (failures, numbers)."""
    from repro_torch import deterministic, tree
    from repro_torch.configs import get_config
    from repro_torch.core import ScheduleConfig
    from repro_torch.models import model as mdl
    from repro_torch.optim import AdamConfig
    from repro_torch.train import Trainer, checkpoint

    cfg = get_config("gpt-tiny")
    base = mdl.init_params(cfg, 1, dtype=torch.float32, device="cpu")
    B, S = 8, 64

    def trainer(device):
        return Trainer(cfg, ScheduleConfig(num_microbatches=4, alpha=0.25),
                       AdamConfig(lr=1e-3), params=tree.tree_map(
                           lambda t: t.clone(), base), device=device)

    failures = []
    runs = {}
    for dev in ("cuda", "cpu"):
        tr = trainer(dev)
        losses = tr.run(4, B, S, log_every=0).losses
        runs[dev] = (losses, torch.cat([t.reshape(-1).cpu() for t in
                                        tree.leaves(tr.state.adam.master)]))
    (lc, mc), (lp, mp) = runs["cuda"], runs["cpu"]
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(lc, lp))
    master_err = (mc - mp).abs().max().item()
    n_ok = loss_rel <= TRAINER_LOSS_RTOL and all(map(math.isfinite, lc))
    if not n_ok:
        failures.append(f"(n) Trainer card {lc} vs CPU {lp}: loss rel "
                        f"{loss_rel} > {TRAINER_LOSS_RTOL}")
    report(f"(n) gpt-tiny Trainer from f32 params (vertical, M 4, alpha "
           f"0.25: bf16 params from the first step's flush on) card {lc} "
           f"vs CPU {lp}: loss rel {loss_rel:.3e} (tol "
           f"{TRAINER_LOSS_RTOL}), final f32 masters max abs diff "
           f"{master_err:.3e} (reported) -> {'OK' if n_ok else 'FAIL'}")

    ck = tempfile.mkdtemp(prefix="trainer-ckpt-", dir=workroot)
    try:
        with deterministic():
            whole = trainer("cuda")
            lw = whole.run(4, B, S, log_every=0).losses
            a = trainer("cuda")
            la = a.run(2, B, S, log_every=0).losses
            t_s = time.perf_counter()
            checkpoint.save(ck, a.params, a.state, step=a.step_num)
            save_s = time.perf_counter() - t_s
            b = trainer("cuda")
            b.params, b.state, b.step_num = checkpoint.restore(
                ck, a.params, a.state)
            for _ in range(b.step_num):
                b.data.batch(B, S)
            lb = b.run(2, B, S, log_every=0).losses
    finally:
        shutil.rmtree(ck, ignore_errors=True)
    leaves_equal = all(
        torch.equal(x, y) if isinstance(y, torch.Tensor) else x == y
        for x, y in zip(tree.leaves((b.params, b.state)),
                        tree.leaves((whole.params, whole.state))))
    o_ok = la + lb == lw and leaves_equal
    if not o_ok:
        failures.append(f"(o) Trainer resume {la + lb} vs uninterrupted "
                        f"{lw}, every leaf equal {leaves_equal}")
    report(f"(o) gpt-tiny f32 Trainer checkpoint after step 2 (save "
           f"{save_s:.2f} s) restored into a fresh Trainer: losses {la + lb}"
           f" == uninterrupted {lw}, every param and optimizer leaf "
           f"bitwise {leaves_equal} -> {'OK' if o_ok else 'FAIL'}")
    return failures, {"card_losses": lc, "cpu_losses": lp,
                      "loss_rel": loss_rel, "master_max_abs": master_err,
                      "resumed_losses": la + lb, "uninterrupted_losses": lw,
                      "resume_bitwise": o_ok}


def phase_entry(torch, fa, fad, report, workroot):
    """The port's entry points through their ``main(argv)``: (l) the
    training CLI in memory at GPT-100M full width and depth, 30 steps of
    16 x 256 tokens, M 4, alpha 0.25 (train_gpt100m.py's shape): the loss
    falls and K1's launches are those the code implies; (m) the CLI
    under ``--offload`` at GPT-100M, 3 steps at its defaults: bytes ==
    plan_traffic x steps and the closed forms, losses against the
    in-memory oracle from the same seed-0 f32 params and batches, K1 and
    K2 launches; (n), (o) the gpt-tiny Trainer gates; (p) the kernel
    benchmark, every row within its tolerance; (q) the six examples
    (lp_config_search is host-only arithmetic) each returning with its
    own check passed. Returns (failures, stats)."""
    import gc

    from repro_torch.bench import kernels as bench_kernels
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLM
    from repro_torch.examples import (lp_config_search, offload_ssd_demo,
                                      quickstart, serve_batched, train_dp,
                                      train_gpt100m)
    from repro_torch.launch import train as cli
    from repro_torch.models import model as mdl

    failures, stats = [], {}
    cfg = get_config("gpt-100m")
    L = cfg.num_layers

    # (l) the CLI in memory
    steps, B, S = ENTRY_STEPS, 16, 256
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    fa.fwd_launches = fa.bwd_launches = fad.launches = 0   # path starts
    t0 = time.perf_counter()
    out = cli.main(["--arch", "gpt-100m", "--steps", str(steps), "--batch",
                    str(B), "--seq", str(S), "--microbatches", "4",
                    "--alpha", "0.25"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = (fa.fwd_launches, fa.bwd_launches, fad.launches)  # ends
    # loss_fn runs every layer under torch.utils.checkpoint: a layer's
    # forward runs twice a step (once more to recompute for backward)
    want = (2 * L * steps, L * steps, 0)
    losses = out["losses"]
    falls = sum(losses[-5:]) / 5 < losses[0]
    l_ok = launches == want and falls and all(map(math.isfinite, losses))
    if not l_ok:
        failures.append(f"(l) CLI in memory: launches (K1 fwd, K1 bwd, K2) "
                        f"{launches} != {want} or the loss did not fall: "
                        f"{losses}")
    cli_stats = {
        "model": cfg.name, "layers": L, "steps": steps, "batch": B,
        "seq_len": S, "micro_batches": 4, "alpha": 0.25, "losses": losses,
        "s_per_step": 1.0 / out["steps_per_s"],
        "tokens_per_s": out["tokens_per_s"], "wall_s": wall,
        "max_memory_allocated": torch.cuda.max_memory_allocated(),
        "launches": {"k1_fwd": launches[0], "k1_bwd": launches[1],
                     "k2": launches[2]}}
    report(f"(l) CLI in memory, {cfg.name} full width and depth "
           f"({L} layers, d_model {cfg.d_model}, {cfg.num_heads} heads x "
           f"{cfg.head_dim}), {steps} steps of {B} x {S} tokens, M 4, alpha "
           f"0.25: {cli_stats['s_per_step']:.4f} s/step, "
           f"{out['tokens_per_s']:.0f} tokens/s (steps 2..{steps}), "
           f"max_memory_allocated "
           f"{cli_stats['max_memory_allocated'] / 2**30:.2f} GiB, loss "
           f"{losses[0]:.4f} -> {losses[-1]:.4f} (mean of the last five "
           f"below the first: {falls}); launches (K1 fwd, K1 bwd, K2) "
           f"{launches}, want {want} -> {'OK' if l_ok else 'FAIL'}")
    stats["cli"] = cli_stats

    # (m) the CLI under --offload, at its defaults
    steps = 3
    workdir = tempfile.mkdtemp(prefix="entry-offload-", dir=workroot)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    fa.fwd_launches = fa.bwd_launches = fad.launches = 0   # path starts
    try:
        t0 = time.perf_counter()
        out = cli.main(["--arch", "gpt-100m", "--steps", str(steps),
                        "--offload", "--ssd-dir", workdir])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = (fa.fwd_launches, fa.bwd_launches, fad.launches)  # ends
        peak = torch.cuda.max_memory_allocated()
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    eng = out["engine"]
    ocfg = eng.ocfg
    M = ocfg.num_microbatches
    byte_errs, _ = check_train_bytes(eng, cfg, ocfg, steps)
    failures += [f"(m) {e}" for e in byte_errs]
    # the engine's construction runs one layer forward to size the
    # activation payload (offload/engine.py, act_residual_nbytes); then
    # every step runs each (layer, micro-batch) forward twice
    want = (2 * L * M * steps + 1, L * M * steps, 3 * steps)
    if launches != want:
        failures.append(f"(m) launches (K1 fwd, K1 bwd, K2) {launches} != "
                        f"{want}")
    params = mdl.init_params(cfg, 0, dtype=torch.float32)
    data = SyntheticLM(cfg.vocab_size, seed=0)
    batches = [data.batch(M * ocfg.micro_batch, ocfg.seq_len)
               for _ in range(steps)]
    oracle = oracle_losses(torch, cfg, params, batches, ocfg.lr)
    del params
    losses = out["losses"]
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, oracle)]
    m_loss_ok = all(r <= LOSS_RTOL for r in rel) and all(
        map(math.isfinite, losses))
    if not m_loss_ok:
        failures.append(f"(m) losses {losses} vs oracle {oracle}: rel {rel}")
    m_ok = not byte_errs and m_loss_ok and launches == want
    off_stats = {
        "model": cfg.name, "steps": steps, "schedule": ocfg.schedule,
        "micro_batches": M, "micro_batch": ocfg.micro_batch,
        "seq_len": ocfg.seq_len, "alpha": ocfg.alpha,
        "param_dtype": ocfg.param_dtype,
        "ratios": [ocfg.ratios.ckpt, ocfg.ratios.param, ocfg.ratios.opt],
        "losses": losses, "oracle_losses": oracle, "loss_rel_diff": rel,
        "s_per_step": out["seconds"] / steps,
        "tokens_per_s": out["tokens_per_s"], "wall_s": wall,
        "max_memory_allocated": peak, "phase_time": out["phase_time"],
        "traffic": out["traffic"],
        "launches": {"k1_fwd": launches[0], "k1_bwd": launches[1],
                     "k2": launches[2]}}
    report(f"(m) CLI --offload, {cfg.name}, {steps} steps of "
           f"{M} x {ocfg.micro_batch} x {ocfg.seq_len} tokens, "
           f"{ocfg.schedule}, alpha {ocfg.alpha}, {ocfg.param_dtype} "
           f"params: {off_stats['s_per_step']:.3f} s/step, "
           f"{out['tokens_per_s']:.0f} tokens/s, max_memory_allocated "
           f"{peak / 2**30:.2f} GiB; bytes (plan x steps, closed forms): "
           f"{'OK' if not byte_errs else byte_errs}; losses {losses} vs "
           f"in-memory oracle {oracle}: rel {rel} (tol {LOSS_RTOL}); "
           f"launches (K1 fwd, K1 bwd, K2) {launches}, want {want} -> "
           f"{'OK' if m_ok else 'FAIL'}")
    stats["cli_offload"] = off_stats
    del eng, out
    gc.collect()
    torch.cuda.empty_cache()

    # (n), (o)
    f, stats["trainer_tiny"] = trainer_tiny_gates(torch, report, workroot)
    failures += f

    # (p) the kernel benchmark
    rows = bench_kernels.main([])
    bad = [name for name, r in rows.items() if not r["ok"]]
    if bad:
        failures.append(f"(p) kernel benchmark rows out of tolerance: {bad}")
    report(f"(p) kernel benchmark: {len(rows)} rows, "
           f"{'all within tolerance' if not bad else bad}")
    stats["bench_kernels"] = rows

    # (q) the examples, each through its own main and its own checks
    examples = [
        ("train_gpt100m", train_gpt100m.main,
         ["--ckpt-dir", os.path.join(workroot, "gpt100m-ckpt")]),
        ("offload_ssd_demo", offload_ssd_demo.main, []),
        ("train_dp", train_dp.main, ["--verify-single-rank"]),
        ("lp_config_search", lp_config_search.main, []),
        ("serve_batched", serve_batched.main, ["--check"]),
        ("quickstart", quickstart.main,
         ["--wave", "2", "--activation-policy", "spill"]),
    ]
    stats["examples"] = {}
    for name, main, argv in examples:
        t0 = time.perf_counter()
        try:
            res = main(argv)
            ok, why = True, ""
        except SystemExit as e:        # an example's own check failed
            res, ok, why = None, False, str(e)
        secs = time.perf_counter() - t0
        if name == "train_gpt100m" and ok:
            shutil.rmtree(res["checkpoint"], ignore_errors=True)
            ok = res["restored_equal"]
            why = "" if ok else "restored params differ"
        if not ok:
            failures.append(f"(q) example {name} failed its check: {why}")
        report(f"(q) example {name} {' '.join(argv)}: {secs:.1f} s -> "
               f"{'OK' if ok else 'FAIL ' + why}")
        stats["examples"][name] = {"seconds": secs, "ok": ok}
    return failures, stats


def rel_norm(a, b) -> float:
    """||a - b|| / ||b|| in f32."""
    return float((a.float() - b.float()).norm() / b.float().norm())


def grow_caches(torch, mdl, cfg, caches, n: int, batch: int = MOE_B,
                dtype=None):
    """Caches of ``n`` slots holding ``caches``' slots (one fewer) in front:
    each leaf is copied along the one axis where the sizes differ (a
    cross-attention cache of the encoder's frames, a Mamba state, is
    copied whole). ``dtype``: the caches' (bf16 if None)."""
    from repro_torch import tree
    new = mdl.init_caches(cfg, batch, n, dtype or torch.bfloat16)
    for old, dst in zip(tree.leaves(caches), tree.leaves(new)):
        ax = [i for i, (a, b) in enumerate(zip(old.shape, dst.shape))
              if a != b]
        (dst.narrow(ax[0], 0, old.shape[ax[0]]) if ax else dst).copy_(old)
    return new


def moe_generate(torch, fa, report, cfg, label, gate_dtype=None):
    """``cfg`` at its width in bf16 on the card, random weights. The plain
    generation at the reference's capacity: a prefill of MOE_B x MOE_S
    tokens (its MoE drop count) and MOE_GEN greedy ``decode_step``s, each
    timed alone, then two more under ``torch.profiler``. The gate, with
    the blocks' MoE at capacity factor E / K (nothing drops), in
    ``gate_dtype`` (bf16 if None; the same seed's params): a prefill
    into caches of MOE_S slots, MOE_GEN greedy ``decode_step``s, each into
    caches grown by one slot (``grow_caches``: a Mamba state is copied
    whole), and a fresh prefill over prompt + generated tokens. Returns
    (failures, stats): K1 launches == 3 prefills x the plan's attention
    layers (every MLA or GQA prefill goes through K1), K3 launches == 3
    prefills x its Mamba layers, the gate's last decode step's logits
    against the fresh prefill's last logits."""
    import functools
    import gc

    from repro_torch import tree
    from repro_torch.data import SyntheticLM
    from repro_torch.kernels import selective_scan as k3
    from repro_torch.models import blocks as blk
    from repro_torch.models import model as mdl
    from repro_torch.models import moe, moe_ep

    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    params = mdl.init_params(cfg, 0, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in tree.leaves(params))
    data = SyntheticLM(cfg.vocab_size, seed=0)
    prompt = torch.from_numpy(data.batch(MOE_B, MOE_S)).long().to("cuda")
    L = cfg.num_layers
    kinds = blk.build_plan(cfg).all_kinds()
    n_k1 = sum(k.mixer in ("attn", "mla") for k in kinds)
    n_k3 = sum(k.mixer == "mamba" for k in kinds)
    torch.cuda.reset_peak_memory_stats()
    caches = mdl.init_caches(cfg, MOE_B, MOE_S + MOE_GEN + 2)
    fa.fwd_launches = k3.launches = 0            # main path starts here
    moe.reset_dropped()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, caches = mdl.prefill(params, cfg, {"tokens": prompt}, caches)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    dropped = moe.dropped_count()
    tok, step_s = torch.argmax(logits, dim=-1), []
    for i in range(MOE_GEN):
        t0 = time.perf_counter()
        logits, caches = mdl.decode_step(params, cfg, tok[:, None],
                                         MOE_S + i, caches)
        tok = torch.argmax(logits, dim=-1)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    busy = card_busy(torch, lambda: [mdl.decode_step(
        params, cfg, tok[:, None], MOE_S + MOE_GEN + i, caches)
        for i in range(2)])
    del caches
    gate_dtype = gate_dtype or torch.bfloat16
    if gate_dtype != torch.bfloat16:
        del params
        gc.collect()
        torch.cuda.empty_cache()
        params = mdl.init_params(cfg, 0, dtype=gate_dtype)

    real_dispatch = moe_ep.moe_dispatch
    moe_ep.moe_dispatch = functools.partial(
        moe.moe_apply, capacity_factor=cfg.num_experts / cfg.moe_top_k)
    try:
        moe.reset_dropped()
        caches = mdl.init_caches(cfg, MOE_B, MOE_S, gate_dtype)
        logits, caches = mdl.prefill(params, cfg, {"tokens": prompt},
                                     caches)
        toks = [torch.argmax(logits, dim=-1)]
        for i in range(MOE_GEN):
            caches = grow_caches(torch, mdl, cfg, caches, MOE_S + i + 1,
                                 dtype=gate_dtype)
            logits, caches = mdl.decode_step(params, cfg, toks[-1][:, None],
                                             MOE_S + i, caches)
            toks.append(torch.argmax(logits, dim=-1))
        last = logits
        full = torch.cat([prompt] + [t[:, None] for t in toks[:-1]], dim=1)
        fresh = mdl.init_caches(cfg, MOE_B, full.shape[1], gate_dtype)
        want, _ = mdl.prefill(params, cfg, {"tokens": full}, fresh)
        torch.cuda.synchronize()
        gate_dropped = moe.dropped_count()
    finally:
        moe_ep.moe_dispatch = real_dispatch
    launches = fa.fwd_launches                   # main path ends here
    k3_launches = k3.launches
    peak = torch.cuda.max_memory_allocated()
    rel = rel_norm(last, want)
    top1 = float((last.argmax(-1) == want.argmax(-1)).float().mean())
    failures = []
    finite = bool(torch.isfinite(last).all()) and bool(
        torch.isfinite(want).all())
    if not finite or rel > LAST_STEP_REL_TOL:
        failures.append(f"({label}) {cfg.name}: last decode step vs fresh "
                        f"prefill rel {rel} (tol {LAST_STEP_REL_TOL}), "
                        f"finite {finite}")
    if launches != 3 * n_k1:
        failures.append(f"({label}) {cfg.name}: K1 launches {launches} != "
                        f"3 prefills x {n_k1} attention layers")
    if k3_launches != 3 * n_k3:
        failures.append(f"({label}) {cfg.name}: K3 launches {k3_launches} "
                        f"!= 3 prefills x {n_k3} Mamba layers")
    if gate_dropped:
        failures.append(f"({label}) {cfg.name}: {gate_dropped} MoE "
                        f"assignments dropped at capacity factor E / K")
    decode_tps = MOE_B * MOE_GEN / sum(step_s)
    median_ms = 1e3 * sorted(step_s)[len(step_s) // 2]
    stats = {"model": cfg.name, "layers": L, "params": n_params,
             "init_s": init_s, "prefill_s": prefill_s,
             "prefill_tokens_per_s": MOE_B * MOE_S / prefill_s,
             "decode_step_s": step_s, "decode_tokens_per_s": decode_tps,
             "decode_2_steps_busy": busy,
             "last_step_rel": rel, "last_step_top1_agree": top1,
             "gate_dtype": str(gate_dtype).replace("torch.", ""),
             "moe_dropped_first_prefill": dropped,
             "moe_assignments_first_prefill":
                 sum(k.moe for k in kinds) * MOE_B * MOE_S * cfg.moe_top_k,
             "k1_launches": launches, "k3_launches": k3_launches,
             "max_memory_allocated": peak}
    report(f"({label}) {cfg.name} ({L} layers, {n_params / 1e9:.2f} B "
           f"params, bf16, init {init_s:.1f} s): prefill {MOE_B} x {MOE_S} "
           f"in {prefill_s:.3f} s ({stats['prefill_tokens_per_s']:.0f} "
           f"tokens/s), decode at capacity 1.25 {decode_tps:.1f} tokens/s "
           f"(median step {median_ms:.1f} ms; 2 steps under the profiler: "
           f"card busy {busy['busy_ms']:.1f} of {busy['wall_ms']:.1f} ms, "
           f"{100 * busy['busy_share']:.1f} %), MoE dropped {dropped} of "
           f"{stats['moe_assignments_first_prefill']} assignments in the "
           f"first prefill, gate ({stats['gate_dtype']}): last step vs "
           f"fresh prefill rel {rel:.4f} (tol {LAST_STEP_REL_TOL}), top-1 "
           f"agree {top1}, K1 "
           f"launches {launches} (want {3 * n_k1}), K3 launches "
           f"{k3_launches} (want {3 * n_k3}), max_memory_allocated "
           f"{peak / 2**30:.2f} GiB -> {'OK' if not failures else 'FAIL'}")
    del params, caches, fresh, logits, want, last
    gc.collect()
    torch.cuda.empty_cache()
    return failures, stats


def archs_smoke_bf16(torch, fa, report, arch=ARCHS_SMOKE_BF16):
    """Gate (w) in bf16: ``arch``'s SMOKE config with the same bf16 params
    on the card and on the CPU: the loss of a training step (2 x 64
    tokens) within ARCHS_SMOKE_BF16_RTOL relative, its backward run (K1's
    bf16 kernels both ways on the card), the gradients' and a 2 x 40
    prefill's relative norm gaps reported. Returns (failures, gaps)."""
    import numpy as np

    from repro_torch import tree
    from repro_torch.configs import get_smoke
    from repro_torch.models import model as mdl

    cfg = get_smoke(arch)
    params = mdl.init_params(cfg, 3, dtype=torch.bfloat16, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 64)))
    out = {}
    before = (fa.fwd_launches, fa.bwd_launches)
    for dev in ("cpu", "cuda"):
        p = tree.tree_map(lambda a: a.detach().to(dev).requires_grad_(),
                          params)
        loss = mdl.loss_fn(p, cfg, {"tokens": toks.to(dev)})
        loss.backward()
        grads = torch.cat([t.grad.float().reshape(-1).cpu()
                           for t in tree.leaves(p)])
        p = tree.tree_map(lambda a: a.detach(), p)
        caches = mdl.init_caches(cfg, 2, 48, torch.bfloat16, device=dev)
        logits, _ = mdl.prefill(p, cfg, {"tokens": toks[:, :40].to(dev)},
                                caches)
        out[dev] = (float(loss.detach()), grads, logits.cpu())
    launches = (fa.fwd_launches - before[0], fa.bwd_launches - before[1])
    (lc, gc_, xc), (lg, gg, xg) = out["cpu"], out["cuda"]
    gaps = {"loss_rel": abs(lg - lc) / abs(lc),
            "grad_rel_norm": rel_norm(gg, gc_),
            "prefill_logits_rel_norm": rel_norm(xg, xc),
            "k1_launches": launches}
    ok = gaps["loss_rel"] <= ARCHS_SMOKE_BF16_RTOL and math.isfinite(lg) \
        and min(launches) > 0
    report(f"(w) {arch}-smoke bf16 card vs CPU: loss {lg:.6f} vs {lc:.6f} "
           f"(rel {gaps['loss_rel']:.3e}, tol {ARCHS_SMOKE_BF16_RTOL}), "
           f"gradients rel norm {gaps['grad_rel_norm']:.3e}, prefill logits "
           f"rel norm {gaps['prefill_logits_rel_norm']:.3e}, K1 launches "
           f"(fwd, bwd) {launches} -> {'OK' if ok else 'FAIL'}")
    failures = [] if ok else [f"(w) {arch}-smoke bf16 card vs CPU: {gaps}"]
    return failures, gaps


def frontend_batch(torch, cfg, tokens, seed: int = 0) -> dict:
    """``tokens`` (B, S) on the card with the family's stubbed frontend,
    as the reference's ``make_batch`` draws it: an encoder-decoder's frame
    embeddings (B, F, d), a VLM's image embeddings (B, P, d), f32 of
    standard deviation d^-0.5."""
    import numpy as np
    B = tokens.shape[0]
    rng = np.random.default_rng(seed)
    n = {"encdec": cfg.encoder_seq, "vlm": cfg.frontend_tokens}.get(
        cfg.family)
    out = {"tokens": tokens}
    if n:
        emb = rng.standard_normal((B, n, cfg.d_model)).astype(np.float32)
        key = "enc_embeds" if cfg.family == "encdec" else "image_embeds"
        out[key] = torch.from_numpy(emb * cfg.d_model ** -0.5).to("cuda")
    return out


def frontend_generate(torch, fa, report, cfg, label, B, S, gen,
                      k1_per_prefill, k1_per_step):
    """``cfg`` (an encoder-decoder or a VLM) in bf16 on the card, random
    weights: a prefill of B x S decoder tokens behind the family's
    frontend (frames through the encoder, or the image prefix), ``gen``
    greedy ``decode_step``s into caches grown one slot a step (no step
    sees an empty slot; each step timed alone, the growth not), and a
    fresh prefill over prompt + generated tokens with the same frontend.
    Returns (failures, stats): K1 launches == 2 prefills x
    ``k1_per_prefill`` + gen x ``k1_per_step``, the last decode step's
    logits within LAST_STEP_REL_TOL of the fresh prefill's last logits."""
    import gc

    from repro_torch import tree
    from repro_torch.data import SyntheticLM
    from repro_torch.models import model as mdl

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = mdl.init_params(cfg, 0, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in tree.leaves(params))
    prompt = torch.from_numpy(SyntheticLM(cfg.vocab_size, seed=0).batch(
        B, S)).long().to("cuda")
    batch = frontend_batch(torch, cfg, prompt)
    P = cfg.frontend_tokens if cfg.family == "vlm" else 0
    fa.fwd_launches = 0                          # main path starts here
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    caches = mdl.init_caches(cfg, B, P + S)
    logits, caches = mdl.prefill(params, cfg, batch, caches)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    toks, step_s = [torch.argmax(logits, dim=-1)], []
    for i in range(gen):
        caches = grow_caches(torch, mdl, cfg, caches, P + S + i + 1, B)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, caches = mdl.decode_step(params, cfg, toks[-1][:, None],
                                         P + S + i, caches)
        toks.append(torch.argmax(logits, dim=-1))
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    last = logits
    full = torch.cat([prompt] + [t[:, None] for t in toks[:-1]], dim=1)
    fresh = mdl.init_caches(cfg, B, P + full.shape[1])
    want, _ = mdl.prefill(params, cfg, dict(batch, tokens=full), fresh)
    torch.cuda.synchronize()
    launches = fa.fwd_launches                   # main path ends here
    want_launches = 2 * k1_per_prefill + gen * k1_per_step
    peak = torch.cuda.max_memory_allocated()
    rel = rel_norm(last, want)
    top1 = float((last.argmax(-1) == want.argmax(-1)).float().mean())
    failures = []
    finite = bool(torch.isfinite(last).all()) and bool(
        torch.isfinite(want).all())
    if not finite or rel > LAST_STEP_REL_TOL:
        failures.append(f"({label}) {cfg.name}: last decode step vs fresh "
                        f"prefill rel {rel} (tol {LAST_STEP_REL_TOL}), "
                        f"finite {finite}")
    if launches != want_launches:
        failures.append(f"({label}) {cfg.name}: K1 launches {launches} != "
                        f"{want_launches}")
    decode_tps = B * gen / sum(step_s)
    median_ms = 1e3 * sorted(step_s)[len(step_s) // 2]
    stats = {"model": cfg.name, "layers": cfg.num_layers,
             "encoder_layers": cfg.encoder_layers, "params": n_params,
             "init_s": init_s, "batch": B, "prompt": S, "frontend":
                 cfg.encoder_seq if cfg.family == "encdec" else P,
             "prefill_s": prefill_s, "decode_step_s": step_s,
             "decode_tokens_per_s": decode_tps,
             "decode_step_ms_median": median_ms, "last_step_rel": rel,
             "last_step_top1_agree": top1, "k1_launches": launches,
             "k1_launches_want": want_launches, "max_memory_allocated": peak}
    report(f"({label}) {cfg.name} ({cfg.num_layers} layers"
           + (f" + {cfg.encoder_layers} encoder over {cfg.encoder_seq} "
              f"frames" if cfg.family == "encdec" else
              f" behind {P} image positions")
           + f", {n_params / 1e9:.3f} B params, bf16, init {init_s:.1f} s): "
           f"prefill {B} x {S} in {prefill_s:.3f} s, decode {gen} steps "
           f"{decode_tps:.1f} tokens/s (median step {median_ms:.2f} ms, "
           f"each timed alone), last step vs fresh prefill rel {rel:.4f} "
           f"(tol {LAST_STEP_REL_TOL}), top-1 agree {top1}, K1 launches "
           f"{launches} (want {want_launches}), max_memory_allocated "
           f"{peak / 2**30:.2f} GiB -> {'OK' if not failures else 'FAIL'}")
    del params, caches, fresh, logits, want, last, batch
    gc.collect()
    torch.cuda.empty_cache()
    return failures, stats


def archs_smoke_parity(torch, report, archs=SMOKE_ARCHS):
    """Gate (w): the SMOKE configs of ``archs`` in f32, the same params on
    the card and on the CPU: a training step's loss and gradients
    (``loss_fn`` + backward, 2 x 64 tokens), then prefill of 2 x 40 tokens
    and 4 decode steps' logits, each within ARCHS_SMOKE_TOL. An
    encoder-decoder's batch adds its frame embeddings (the encoder, and
    cross-attention at Sq != Skv and, in decode, at Sq = 1), a VLM's its
    image prefix (decode positions follow it). A stack with Mamba layers
    trains through the model's chunked scan on both devices (held at
    ARCHS_SMOKE_TOL); its prefill runs K3 on the card, and its logits are
    held at MAMBA_PARITY_TOL with each decode step started on the card
    from the CPU's caches, as :func:`mamba_parity` holds falcon-mamba's.
    Returns (failures, gaps by arch)."""
    import numpy as np

    from repro_torch import tree
    from repro_torch.configs import get_smoke
    from repro_torch.models import blocks as blk
    from repro_torch.models import model as mdl

    failures, gaps = [], {}
    for arch in archs:
        cfg = get_smoke(arch)
        ssm = any(k.mixer == "mamba" for k in blk.build_plan(cfg).all_kinds())
        logit_tol = MAMBA_PARITY_TOL if ssm else ARCHS_SMOKE_TOL
        params = mdl.init_params(cfg, 3, dtype=torch.float32, device="cpu")
        rng = np.random.default_rng(0)
        toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 64)))
        extra, P = {}, 0
        if cfg.family == "encdec":
            extra["enc_embeds"] = torch.from_numpy(rng.standard_normal(
                (2, cfg.encoder_seq, cfg.d_model)).astype(np.float32))
        elif cfg.family == "vlm":
            P = cfg.frontend_tokens
            extra["image_embeds"] = torch.from_numpy(rng.standard_normal(
                (2, P, cfg.d_model)).astype(np.float32))
        out, states = {}, []
        for dev in ("cpu", "cuda"):
            ex = {k: v.to(dev) for k, v in extra.items()}
            p = tree.tree_map(
                lambda a: a.detach().to(dev).requires_grad_(), params)
            loss = mdl.loss_fn(p, cfg, {"tokens": toks.to(dev), **ex})
            loss.backward()
            grads = [t.grad.cpu() for t in tree.leaves(p)]
            p = tree.tree_map(lambda a: a.detach(), p)
            caches = mdl.init_caches(cfg, 2, P + 48, torch.float32,
                                     device=dev)
            logits, caches = mdl.prefill(
                p, cfg, {"tokens": toks[:, :40].to(dev), **ex}, caches)
            seq = [logits.cpu()]
            for i in range(4):
                if ssm and dev == "cpu":
                    states.append(tree.tree_map(torch.clone, caches))
                elif ssm:                    # the CPU's caches on the card
                    for dst, src in zip(tree.leaves(caches),
                                        tree.leaves(states[i])):
                        dst.copy_(src)
                logits, caches = mdl.decode_step(
                    p, cfg, toks[:, 40 + i:41 + i].to(dev), P + 40 + i,
                    caches)
                seq.append(logits.cpu())
            out[dev] = (float(loss.detach()), grads, seq)
        (lc, gc_, sc), (lg, gg, sg) = out["cpu"], out["cuda"]
        loss_gap = abs(lc - lg)
        grad_gap = max(float((a - b).abs().max()) / max(1.0, float(
            b.abs().max())) for a, b in zip(gg, gc_))
        logit_gap = max(float((a - b).abs().max()) for a, b in zip(sg, sc))
        gaps[arch] = {"loss": loss_gap, "grad_scaled": grad_gap,
                      "logits": logit_gap, "logit_tol": logit_tol,
                      "decode_from_cpu_state": ssm}
        ok = (max(loss_gap, grad_gap) <= ARCHS_SMOKE_TOL
              and logit_gap <= logit_tol)
        if not ok:
            failures.append(f"(w) {arch}-smoke f32 card vs CPU: {gaps[arch]}"
                            f" (tol {ARCHS_SMOKE_TOL})")
        report(f"(w) {arch}-smoke f32 card vs CPU: loss {loss_gap:.3e}, "
               f"gradients {grad_gap:.3e} (of each leaf's max; tol "
               f"{ARCHS_SMOKE_TOL}), prefill + 4 decode logits "
               f"{logit_gap:.3e} (tol {logit_tol}"
               + (", each decode step from the CPU's caches" if ssm else "")
               + f") -> {'OK' if ok else 'FAIL'}")
    return failures, gaps


def phase_archs(torch, fa, report, workroot):
    """The attention architectures at full width on the card, each through
    the port's own entry points: (r) gemma3-1b served, (s) gemma3-1b
    trained through the CLI, (t) deepseek-v2-lite-16b generating at full
    size, (u) deepseek-v2-lite-16b trained (2 layers), (v)
    qwen3-moe-235b-a22b generating (2 layers), (w) the five SMOKE configs
    card vs CPU. Returns (failures, stats)."""
    import gc

    from repro_torch.configs import get_config
    from repro_torch.launch import train as cli
    from repro_torch.train import Trainer
    from repro_torch.core import ScheduleConfig
    from repro_torch.optim import AdamConfig

    failures, stats, wall = [], {}, {}

    # (r) gemma3-1b through ServeEngine
    t0 = time.perf_counter()
    cfg = get_config("gemma3-1b")
    report(f"(r) serve model: {cfg.name} at full size ({cfg.num_layers} "
           f"layers, window {cfg.sliding_window} on all but every "
           f"{cfg.global_attn_every}th, d_model {cfg.d_model}, "
           f"{cfg.num_heads}:{cfg.num_kv_heads} heads x {cfg.head_dim}, "
           f"vocab {cfg.vocab_size}), bf16 params, prompts "
           f"{ARCHS_SERVE_PROMPTS}, {ARCHS_GEN} new tokens each")
    f, st = phase_serve(torch, fa, report, cfg, ARCHS_SERVE_PROMPTS,
                        ARCHS_GEN, workroot)
    failures += [f"(r) {m}" for m in f]
    report(f"(r) {cfg.name} served: {st['prefills']} prefills, K1 launches "
           f"{st['k1_launches']} (want {st['k1_launches_want']}), decode "
           f"{st['decode_tokens_per_s']:.3f} tokens/s, end to end "
           f"{st['end_to_end_tokens_per_s']:.3f} tokens/s over "
           f"{st['steps']} steps in {st['run_s']:.2f} s, KV hit rate "
           f"{st['kv_hit_rate']:.3f} -> {'OK' if not f else 'FAIL'}")
    stats["serve_gemma3"] = st
    wall["r"] = time.perf_counter() - t0

    # (s) gemma3-1b trained through the CLI in memory
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    n_k1 = k1_layers(cfg, GEMMA_TRAIN_S)
    fa.fwd_launches = fa.bwd_launches = 0        # main path starts here
    out = cli.main(["--arch", "gemma3-1b", "--steps", str(GEMMA_TRAIN_STEPS),
                    "--batch", str(GEMMA_TRAIN_B), "--seq",
                    str(GEMMA_TRAIN_S), "--microbatches", "2", "--alpha",
                    "0.25"])
    torch.cuda.synchronize()
    launches = (fa.fwd_launches, fa.bwd_launches)  # main path ends here
    # every layer runs under checkpoint: K1's forward twice a step
    want = (2 * n_k1 * GEMMA_TRAIN_STEPS, n_k1 * GEMMA_TRAIN_STEPS)
    losses = out["losses"]
    ok = (launches == want and all(map(math.isfinite, losses))
          and losses[-1] < losses[0])
    if not ok:
        failures.append(f"(s) gemma3-1b CLI: launches {launches} != {want} "
                        f"or losses not finite and falling: {losses}")
    stats["train_gemma3"] = {
        "steps": GEMMA_TRAIN_STEPS, "batch": GEMMA_TRAIN_B,
        "seq_len": GEMMA_TRAIN_S, "micro_batches": 2, "alpha": 0.25,
        "losses": losses, "s_per_step": 1.0 / out["steps_per_s"],
        "tokens_per_s": out["tokens_per_s"],
        "max_memory_allocated": torch.cuda.max_memory_allocated(),
        "launches": {"k1_fwd": launches[0], "k1_bwd": launches[1]}}
    report(f"(s) {cfg.name} CLI in memory, bf16, {GEMMA_TRAIN_STEPS} steps "
           f"of {GEMMA_TRAIN_B} x {GEMMA_TRAIN_S}, M 2, alpha 0.25: "
           f"{1.0 / out['steps_per_s']:.3f} s/step, "
           f"{out['tokens_per_s']:.0f} tokens/s, loss {losses[0]:.4f} -> "
           f"{losses[-1]:.4f}, K1 launches (fwd, bwd) {launches} (want "
           f"{want}: {n_k1} global layers), max_memory_allocated "
           f"{stats['train_gemma3']['max_memory_allocated'] / 2**30:.2f} "
           f"GiB -> {'OK' if ok else 'FAIL'}")
    wall["s"] = time.perf_counter() - t0

    # (t) deepseek-v2-lite-16b at full size, in memory
    t0 = time.perf_counter()
    f, stats["generate_deepseek"] = moe_generate(
        torch, fa, report, get_config("deepseek-v2-lite-16b"), "t")
    failures += f
    wall["t"] = time.perf_counter() - t0

    # (u) deepseek-v2-lite-16b trained, depth cut to 2 layers
    t0 = time.perf_counter()
    full = get_config("deepseek-v2-lite-16b")
    cfg = dataclasses.replace(full, num_layers=DS_TRAIN_LAYERS)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    tr = Trainer(cfg, ScheduleConfig(num_microbatches=2, alpha=0.25),
                 AdamConfig(lr=1e-3))
    fa.fwd_launches = fa.bwd_launches = 0        # main path starts here
    rep = tr.run(DS_TRAIN_STEPS, DS_TRAIN_B, DS_TRAIN_S, log_every=0)
    torch.cuda.synchronize()
    launches = (fa.fwd_launches, fa.bwd_launches)  # main path ends here
    want = (2 * DS_TRAIN_LAYERS * DS_TRAIN_STEPS,
            DS_TRAIN_LAYERS * DS_TRAIN_STEPS)
    losses = rep.losses
    ok = (launches == want and all(map(math.isfinite, losses))
          and losses[-1] < losses[0])
    if not ok:
        failures.append(f"(u) deepseek-v2-lite-16b Trainer: launches "
                        f"{launches} != {want} or losses not finite and "
                        f"falling: {losses}")
    stats["train_deepseek"] = {
        "layers": DS_TRAIN_LAYERS, "steps": DS_TRAIN_STEPS,
        "batch": DS_TRAIN_B, "seq_len": DS_TRAIN_S, "losses": losses,
        "tokens_per_s": rep.tokens_per_s,
        "max_memory_allocated": torch.cuda.max_memory_allocated(),
        "launches": {"k1_fwd": launches[0], "k1_bwd": launches[1]}}
    report(f"(u) {full.name} Trainer, full width, depth cut "
           f"{full.num_layers} -> {DS_TRAIN_LAYERS} (the dense layer and "
           f"one MoE layer), bf16, {DS_TRAIN_STEPS} steps of {DS_TRAIN_B} x "
           f"{DS_TRAIN_S}, M 2, alpha 0.25: {rep.tokens_per_s:.0f} "
           f"tokens/s, loss {losses[0]:.4f} -> {losses[-1]:.4f}, K1 "
           f"launches (fwd, bwd) {launches} (want {want}), "
           f"max_memory_allocated "
           f"{stats['train_deepseek']['max_memory_allocated'] / 2**30:.2f} "
           f"GiB -> {'OK' if ok else 'FAIL'}")
    del tr
    wall["u"] = time.perf_counter() - t0

    # (v) qwen3-moe-235b-a22b, depth cut to 2 layers
    t0 = time.perf_counter()
    full = get_config("qwen3-moe-235b-a22b")
    f, stats["generate_qwen3_moe"] = moe_generate(
        torch, fa, report, dataclasses.replace(
            full, num_layers=QWEN_MOE_LAYERS), "v")
    failures += f
    wall["v"] = time.perf_counter() - t0

    # (w) the seven SMOKE configs, f32, card against CPU; deepseek's in bf16
    t0 = time.perf_counter()
    f, stats["smoke_card_vs_cpu"] = archs_smoke_parity(torch, report)
    failures += f
    f, stats["smoke_card_vs_cpu_bf16"] = archs_smoke_bf16(torch, fa, report)
    failures += f
    wall["w"] = time.perf_counter() - t0

    # (x) whisper-base at full size: trained through the CLI, served
    t0 = time.perf_counter()
    f, stats["whisper"] = whisper_gates(torch, fa, report)
    failures += f
    wall["x"] = time.perf_counter() - t0

    # (y) internvl2-76b at full width, depth cut
    t0 = time.perf_counter()
    f, stats["internvl2"] = internvl2_gates(torch, fa, report)
    failures += f
    wall["y"] = time.perf_counter() - t0
    stats["gate_wall_s"] = wall
    return failures, stats


def whisper_gates(torch, fa, report):
    """Gate (x), whisper-base at full size. Training through the CLI in
    memory (``WHISPER_TRAIN_STEPS`` steps of ``WHISPER_TRAIN_B`` x
    ``WHISPER_TRAIN_S`` tokens over as many 1500-frame embeddings, M 2,
    alpha 0.25, the vertical schedule: one forward and backward of the
    whole batch a step). K1 launches, derived from the plan: every
    encoder block (6, non-causal self-attention over the 1500 frames) and
    every decoder block (6, causal self-attention and cross-attention of
    the 448 tokens against the 1500 frames) runs under checkpoint, so
    each of the 6 + 2 x 6 = 18 attentions launches K1's forward twice a
    step (the forward, the recomputation) and its backward once: 36 and
    18 a step. Gates: those counts, finite losses whose last is below the
    first. Then the generation (``frontend_generate``): a prefill of
    ``WHISPER_B`` x ``WHISPER_PROMPT`` tokens over the frames (18 K1
    launches: the encoder's 6, the decoder's 6 self and 6 cross), then
    ``WHISPER_GEN`` greedy decode steps (6 a step: cross-attention at
    Sq = 1 against the cached 1500 frames; self-attention decodes without
    K1), and a fresh prefill. Returns (failures, stats)."""
    import gc

    from repro_torch.configs import get_config
    from repro_torch.launch import train as cli

    cfg = get_config("whisper-base")
    L, E = cfg.num_layers, cfg.encoder_layers
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    fa.fwd_launches = fa.bwd_launches = 0        # main path starts here
    out = cli.main(["--arch", "whisper-base", "--steps",
                    str(WHISPER_TRAIN_STEPS), "--batch", str(WHISPER_TRAIN_B),
                    "--seq", str(WHISPER_TRAIN_S), "--microbatches", "2",
                    "--alpha", "0.25"])
    torch.cuda.synchronize()
    launches = (fa.fwd_launches, fa.bwd_launches)  # main path ends here
    n_att = E + 2 * L
    want = (2 * n_att * WHISPER_TRAIN_STEPS, n_att * WHISPER_TRAIN_STEPS)
    losses = out["losses"]
    failures = []
    ok = (launches == want and all(map(math.isfinite, losses))
          and losses[-1] < losses[0])
    if not ok:
        failures.append(f"(x) whisper-base CLI: launches {launches} != "
                        f"{want} or losses not finite and falling: {losses}")
    train = {"steps": WHISPER_TRAIN_STEPS, "batch": WHISPER_TRAIN_B,
             "seq_len": WHISPER_TRAIN_S, "frames": cfg.encoder_seq,
             "micro_batches": 2, "alpha": 0.25, "losses": losses,
             "s_per_step": 1.0 / out["steps_per_s"],
             "tokens_per_s": out["tokens_per_s"],
             "max_memory_allocated": torch.cuda.max_memory_allocated(),
             "launches": {"k1_fwd": launches[0], "k1_bwd": launches[1]}}
    report(f"(x) {cfg.name} CLI in memory ({E} + {L} layers, d_model "
           f"{cfg.d_model}, {cfg.encoder_seq} frames), bf16, "
           f"{WHISPER_TRAIN_STEPS} steps of {WHISPER_TRAIN_B} x "
           f"{WHISPER_TRAIN_S}, M 2, alpha 0.25: "
           f"{train['s_per_step']:.4f} s/step, "
           f"{out['tokens_per_s']:.0f} tokens/s, loss {losses[0]:.4f} -> "
           f"{losses[-1]:.4f}, K1 launches (fwd, bwd) {launches} (want "
           f"{want}), max_memory_allocated "
           f"{train['max_memory_allocated'] / 2**30:.2f} GiB -> "
           f"{'OK' if ok else 'FAIL'}")
    f, gen = frontend_generate(torch, fa, report, cfg, "x", WHISPER_B,
                               WHISPER_PROMPT, WHISPER_GEN, n_att, L)
    return failures + f, {"train": train, "generate": gen}


def internvl2_gates(torch, fa, report):
    """Gate (y), internvl2-76b at full width: the generation
    (``frontend_generate``) at ``VLM_LAYERS`` layers, 1 x (256 image +
    ``VLM_TEXT`` text) positions, ``VLM_GEN`` decode steps (K1 once a
    layer a prefill, causal at hd 128 with 64 q heads on 8 KV heads;
    decode attends without K1); then the Trainer at ``VLM_TRAIN_LAYERS``
    layer, ``VLM_TRAIN_STEPS`` steps of ``VLM_TRAIN_B`` x ``VLM_TRAIN_S``
    positions (256 image + 768 text), M 2, alpha 0, lr 1e-4: K1 forward
    twice and backward once a layer a step, finite losses, and the first
    batch's loss under the trained params below its step-1 loss (each
    step draws a fresh batch and fresh image embeddings, so step losses
    alone are no gate at 4 steps; at lr 1e-3 the step losses ran 12.169,
    12.172, 12.114, 12.243 on an H100: the first Adam steps move each of
    the 8192 inputs of a logit by ~lr). Returns (failures, stats)."""
    import gc

    from repro_torch import tree
    from repro_torch.configs import get_config
    from repro_torch.core import ScheduleConfig
    from repro_torch.data import SyntheticLM, make_batch
    from repro_torch.models import model as mdl
    from repro_torch.optim import AdamConfig
    from repro_torch.train import Trainer

    full = get_config("internvl2-76b")
    cfg = dataclasses.replace(full, num_layers=VLM_LAYERS)
    f, gen = frontend_generate(torch, fa, report, cfg, "y", 1, VLM_TEXT,
                               VLM_GEN, VLM_LAYERS, 0)
    failures = list(f)
    cfg = dataclasses.replace(full, num_layers=VLM_TRAIN_LAYERS)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tr = Trainer(cfg, ScheduleConfig(num_microbatches=2), AdamConfig(lr=1e-4))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in tree.leaves(tr.params))
    fa.fwd_launches = fa.bwd_launches = 0        # main path starts here
    rep = tr.run(VLM_TRAIN_STEPS, VLM_TRAIN_B, VLM_TRAIN_S, log_every=0)
    torch.cuda.synchronize()
    launches = (fa.fwd_launches, fa.bwd_launches)  # main path ends here
    want = (2 * VLM_TRAIN_LAYERS * VLM_TRAIN_STEPS,
            VLM_TRAIN_LAYERS * VLM_TRAIN_STEPS)
    losses = rep.losses
    # the Trainer's first batch again (its data stream from the start)
    first = make_batch(cfg, VLM_TRAIN_B, VLM_TRAIN_S, seed=1,
                       data=SyntheticLM(cfg.vocab_size, seed=0))
    with torch.no_grad():
        refit = float(mdl.loss_fn(tr.params, cfg, {
            k: torch.from_numpy(v).to("cuda") for k, v in first.items()}))
    ok = (launches == want and all(map(math.isfinite, losses))
          and refit < losses[0])
    if not ok:
        failures.append(f"(y) internvl2-76b Trainer: launches {launches} != "
                        f"{want}, losses not finite {losses}, or the first "
                        f"batch's loss {refit} not below {losses[0]}")
    train = {"layers": VLM_TRAIN_LAYERS, "params": n_params,
             "init_s": init_s, "steps": VLM_TRAIN_STEPS,
             "batch": VLM_TRAIN_B, "seq_len": VLM_TRAIN_S,
             "image_positions": cfg.frontend_tokens, "losses": losses,
             "first_batch_loss_trained": refit,
             "s_per_step": (1.0 / rep.steps_per_s if rep.steps_per_s
                            else None),
             "tokens_per_s": rep.tokens_per_s,
             "max_memory_allocated": torch.cuda.max_memory_allocated(),
             "launches": {"k1_fwd": launches[0], "k1_bwd": launches[1]}}
    report(f"(y) {full.name} Trainer, full width, depth cut "
           f"{full.num_layers} -> {VLM_TRAIN_LAYERS} ({n_params / 1e9:.3f} B "
           f"params), bf16, {VLM_TRAIN_STEPS} steps of {VLM_TRAIN_B} x "
           f"{VLM_TRAIN_S} ({cfg.frontend_tokens} image + "
           f"{VLM_TRAIN_S - cfg.frontend_tokens} text), M 2, alpha 0: "
           f"{rep.tokens_per_s:.0f} tokens/s, loss {losses[0]:.4f} -> "
           f"{losses[-1]:.4f}, the first batch's {losses[0]:.4f} -> "
           f"{refit:.4f}, K1 launches (fwd, bwd) {launches} (want "
           f"{want}), max_memory_allocated "
           f"{train['max_memory_allocated'] / 2**30:.2f} GiB -> "
           f"{'OK' if ok else 'FAIL'}")
    del tr
    gc.collect()
    torch.cuda.empty_cache()
    return failures, {"generate": gen, "train": train}


def phase_hybrid(torch, fa, report):
    """The hybrid family: (z1) jamba-v0.1-52b generating at full width over
    one 8-layer block (``moe_generate``), (z2) trained at 2 layers
    (:func:`jamba_train_gates`), (w) the SMOKE configs of Jamba and
    falcon-mamba-7b card vs CPU. Returns (failures, stats)."""
    from repro_torch.configs import get_config

    failures, stats, wall = [], {}, {}
    full = get_config("jamba-v0.1-52b")
    t0 = time.perf_counter()
    f, stats["generate"] = moe_generate(
        torch, fa, report, dataclasses.replace(
            full, num_layers=JAMBA_GEN_LAYERS), "z1",
        gate_dtype=torch.float32)
    failures += f
    wall["z1"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    f, stats["train"] = jamba_train_gates(torch, fa, report, full)
    failures += f
    wall["z2"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    f, stats["smoke_card_vs_cpu"] = archs_smoke_parity(
        torch, report, archs=HYBRID_SMOKE_ARCHS)
    failures += f
    wall["w"] = time.perf_counter() - t0
    stats["gate_wall_s"] = wall
    return failures, stats


def jamba_train_gates(torch, fa, report, full):
    """Gate (z2): ``full`` at ``JAMBA_TRAIN_LAYERS`` layers (Mamba + MLP,
    Mamba + MoE) through the ``Trainer``, bf16, alpha 0, lr 1e-4,
    ``JAMBA_TRAIN_STEPS`` steps of ``JAMBA_TRAIN_B`` x ``JAMBA_TRAIN_S``
    tokens, M ``JAMBA_TRAIN_M``: finite losses, the first batch's loss under
    the trained params below its step-1 loss (as (y)), and no kernel
    launch: the layers hold no attention, the Trainer's Adam is the
    model's own, and training runs the model's chunked scan (K3 has no
    backward, in the reference too). Then where a step's time goes: one
    step more under ``torch.profiler`` (``card_busy``: the card's busy
    share), and one with the chunked scan replaced by its ``D x`` term
    alone (same shapes and gradients' paths, no recurrence): the step
    time that the scan takes is the gated steps' mean less that step's.
    Returns (failures, stats)."""
    import gc

    from repro_torch import tree
    from repro_torch.core import ScheduleConfig
    from repro_torch.data import SyntheticLM, make_batch
    from repro_torch.kernels import fused_adam as fad
    from repro_torch.kernels import selective_scan as k3
    from repro_torch.models import mamba as mamba_lib
    from repro_torch.models import model as mdl
    from repro_torch.optim import AdamConfig
    from repro_torch.train import Trainer

    cfg = dataclasses.replace(full, num_layers=JAMBA_TRAIN_LAYERS)
    B, S, M = JAMBA_TRAIN_B, JAMBA_TRAIN_S, JAMBA_TRAIN_M
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tr = Trainer(cfg, ScheduleConfig(num_microbatches=M), AdamConfig(lr=1e-4))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in tree.leaves(tr.params))
    fa.fwd_launches = fa.bwd_launches = 0        # main path starts here
    k3.launches = fad.launches = 0
    rep = tr.run(JAMBA_TRAIN_STEPS, B, S, log_every=0)
    torch.cuda.synchronize()
    launches = {"k1_fwd": fa.fwd_launches, "k1_bwd": fa.bwd_launches,
                "k2": fad.launches, "k3": k3.launches}  # main path ends here
    peak = torch.cuda.max_memory_allocated()
    losses = rep.losses
    # the Trainer's first batch again (its data stream from the start)
    first = make_batch(cfg, B, S, seed=1,
                       data=SyntheticLM(cfg.vocab_size, seed=0))
    with torch.no_grad():
        refit = float(mdl.loss_fn(tr.params, cfg, {
            k: torch.from_numpy(v).to("cuda") for k, v in first.items()}))
    failures = []
    ok = (all(v == 0 for v in launches.values())
          and all(map(math.isfinite, losses)) and refit < losses[0])
    if not ok:
        failures.append(f"(z2) {cfg.name} Trainer: launches {launches} (want "
                        f"none), losses not finite {losses}, or the first "
                        f"batch's loss {refit} not below {losses[0]}")
    step = card_busy(torch, lambda: tr.run(1, B, S, log_every=0))
    real_scan = mamba_lib.selective_scan

    def d_x_only(x, dt, A, Bc, Cc, D, *, h0=None, chunk=64):
        y = x.float() * D + 0.0 * (dt + A.sum() + Bc.float().sum(-1, True)
                                   + Cc.float().sum(-1, True))
        return y.to(x.dtype), None
    mamba_lib.selective_scan = d_x_only
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tr.run(1, B, S, log_every=0)
        torch.cuda.synchronize()
        no_scan_s = time.perf_counter() - t0
    finally:
        mamba_lib.selective_scan = real_scan
    del tr
    gc.collect()
    torch.cuda.empty_cache()
    stats = {"layers": JAMBA_TRAIN_LAYERS, "params": n_params,
             "init_s": init_s, "steps": JAMBA_TRAIN_STEPS, "batch": B,
             "seq_len": S, "micro_batches": M, "alpha": 0.0, "lr": 1e-4,
             "losses": losses, "first_batch_loss_trained": refit,
             "s_per_step": 1.0 / rep.steps_per_s,
             "tokens_per_s": rep.tokens_per_s,
             "max_memory_allocated": peak, "launches": launches,
             "profiled_step": step, "step_without_scan_s": no_scan_s,
             "chunked_scan_share_of_step":
                 1.0 - no_scan_s * rep.steps_per_s}
    report(f"(z2) {full.name} Trainer, full width, depth cut "
           f"{full.num_layers} -> {JAMBA_TRAIN_LAYERS} (Mamba + MLP, Mamba + "
           f"MoE of {cfg.num_experts}; {n_params / 1e9:.3f} B params), bf16, "
           f"{JAMBA_TRAIN_STEPS} steps of {B} x {S}, M {M}, alpha 0: "
           f"{stats['s_per_step']:.3f} s/step, {rep.tokens_per_s:.0f} "
           f"tokens/s, loss {losses[0]:.4f} -> {losses[-1]:.4f}, the first "
           f"batch's {losses[0]:.4f} -> {refit:.4f}, launches {launches} "
           f"(want none), max_memory_allocated {peak / 2**30:.2f} GiB; one "
           f"step profiled: card busy {step['busy_ms']:.1f} of "
           f"{step['wall_ms']:.1f} ms ({100 * step['busy_share']:.1f} %); "
           f"a step with the scan's D x term alone {no_scan_s:.3f} s (the "
           f"chunked scan "
           f"{100 * stats['chunked_scan_share_of_step']:.1f} % of a step) "
           f"-> {'OK' if ok else 'FAIL'}")
    return failures, stats


def _m2_reference(torch, cfg, tokens, capacity_factor, *, path=None,
                  against=None):
    """The unsharded step of (m2) on the card, M2_STEPS Adam steps at the
    MoE's ``capacity_factor`` (``None``: 1.25): losses, grad norms and
    dropped assignments. The update (the f32 masters less the initial
    params) is saved to ``path`` (every rank cuts its shard of it) and,
    with ``against`` (another run's update on the host), held against it
    leaf by leaf by relative norm. Frees the card before it returns."""
    import gc

    from repro_torch import tree
    from repro_torch.core.schedules import ScheduleConfig, make_train_step
    from repro_torch.launch import sharded
    from repro_torch.models import model as mdl
    from repro_torch.models import moe as moe_lib
    from repro_torch.optim import AdamConfig, init_state

    torch.cuda.reset_peak_memory_stats()
    params = mdl.init_params(cfg, 0, dtype=torch.bfloat16, device="cuda")
    init = tree.tree_map(lambda a: a.clone(), params)
    opt = init_state(params)
    step = make_train_step(cfg, ScheduleConfig("vertical"),
                           AdamConfig(lr=M2_LR))
    batch = {"tokens": torch.from_numpy(tokens).cuda()}
    out = {"losses": [], "grad_norms": [], "seconds": []}
    moe_lib.reset_dropped()
    with sharded.capacity(capacity_factor):
        for _ in range(M2_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, opt, met = step(params, opt, batch)
            torch.cuda.synchronize()
            out["seconds"].append(time.perf_counter() - t0)
            out["losses"].append(float(met["loss"]))
            out["grad_norms"].append(float(met["grad_norm"]))
    out["dropped"] = moe_lib.dropped_count()
    out["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    out["params"] = sum(t.numel() for t in tree.leaves(params))
    update = tree.tree_map(lambda m, p: (m - p.float()).cpu(), opt.master,
                           init)
    if against is not None:
        out["update_rel_by_leaf"] = {
            name: float((u.cuda() - a.cuda()).norm() / a.cuda().norm())
            for (name, u), a in zip(tree.flatten_with_path(update),
                                    tree.leaves(against), strict=True)}
    if path is not None:
        t0 = time.perf_counter()
        torch.save(update, path)
        out["save_s"] = time.perf_counter() - t0
    del params, init, opt, step, met, batch
    gc.collect()
    torch.cuda.empty_cache()
    return out, update


def _serve_job(torch, cfg, seed, capacity_factor):
    """(m4) / (m5)'s rank job: ``init_params`` from ``seed`` in bf16 on
    the card, M4_B x M4_S prompt tokens and M4_GEN decode tokens drawn
    from the seed."""
    import numpy as np
    rng = np.random.default_rng(seed + 100)
    return {"cfg": cfg, "mesh": MESH_SHAPE, "seed": seed,
            "dtype": torch.bfloat16, "capacity": capacity_factor,
            "batch": {"tokens": rng.integers(
                0, cfg.vocab_size, (M4_B, M4_S)).astype(np.int64)},
            "decode_tokens": rng.integers(
                0, cfg.vocab_size, (M4_GEN, M4_B, 1)).astype(np.int64),
            "cache_len": M4_S + M4_GEN}


def _serve_reference(torch, job):
    """The unsharded prefill + decode steps of a serve job on the card:
    every call's logits (host) and seconds. Frees the card."""
    import gc

    from repro_torch import tree
    from repro_torch.launch import sharded
    from repro_torch.models import model as mdl
    cfg = job["cfg"]
    params = mdl.init_params(cfg, job["seed"], dtype=job["dtype"],
                             device="cuda")
    caches = mdl.init_caches(cfg, M4_B, job["cache_len"], dtype=job["dtype"],
                             device="cuda")
    out = {"logits": [], "seconds": [],
           "params": sum(t.numel() for t in tree.leaves(params))}
    pos = M4_S
    with sharded.capacity(job["capacity"]):
        for tok in [None] + list(job["decode_tokens"]):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if tok is None:
                lg, caches = mdl.prefill(params, cfg, {
                    "tokens": torch.from_numpy(
                        job["batch"]["tokens"]).cuda()}, caches)
            else:
                lg, caches = mdl.decode_step(params, cfg, torch.from_numpy(
                    tok).cuda(), pos, caches)
                pos += 1
            torch.cuda.synchronize()
            out["seconds"].append(time.perf_counter() - t0)
            out["logits"].append(lg.cpu())
    del params, caches, lg
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _serve_gates(ranks, k, key, job, ref, report):
    """(m4) / (m5): the ranks' logits (every row) against the unsharded
    run's, each call by relative norm; K1 launches; collective counts."""
    from repro_torch.launch import sharded
    cfg = job["cfg"]
    rs = [r[k] for r in ranks]
    a = rs[0]
    rel = [float((g.float() - w.float()).norm() / w.float().norm())
           for g, w in zip(a["logits_full"], ref["logits"], strict=True)]
    counts_ok = all(sharded.counts_equal(c, e) for r in rs
                    for c, e in zip(r["counts"], r["expected_counts"],
                                    strict=True))
    n_attn = sum(1 for i in range(cfg.num_layers) if cfg.is_attn_layer(i))
    k1 = [r["k1_launches"] for r in rs]
    ok = (max(rel) <= SERVE_REL_TOL and counts_ok
          and k1 == [n_attn] * len(rs) and len(rel) == 1 + M4_GEN)
    gb = [{kind: round(v["result_bytes"] / 1e9, 4)
           for kind, v in c.items() if v["count"]} for c in a["counts"][:2]]
    st = {"model": cfg.name, "layers": cfg.num_layers,
          "params": ref["params"], "logits_rel_by_call": rel,
          "counts_equal_closed_form": counts_ok, "k1_launches_by_rank": k1,
          "seconds_by_rank": [r["seconds"] for r in rs],
          "unsharded_seconds": ref["seconds"],
          "max_memory_allocated_by_rank": [r["max_memory_allocated"]
                                           for r in rs],
          "collectives_prefill_rank0": a["counts"][0],
          "collectives_decode_rank0": a["counts"][1],
          "capacity_factor": job["capacity"],
          "job_seconds": max(r["job_seconds"] for r in rs)}
    report(f"({key}) sharded serving {cfg.name} at full width, "
           f"{cfg.num_layers} layers ({ref['params'] / 1e9:.3f} B params), "
           f"bf16, {M4_B} x {M4_S} prompt + {M4_GEN} decode steps, batch "
           f"over {a['batch_axes']}, caches split over model: logits rel "
           f"by call {[f'{x:.2e}' for x in rel]} (tol {SERVE_REL_TOL}); "
           f"collectives == closed form {counts_ok}; K1 by rank {k1} "
           f"(closed form {n_attn}); s by call (rank 0) "
           f"{[round(t, 3) for t in a['seconds']]} vs unsharded "
           f"{[round(t, 3) for t in ref['seconds']]}; rank 0 result GB "
           f"prefill / decode {gb} -> {'OK' if ok else 'FAIL'}")
    return ([] if ok else [f"({key}) sharded serving: " + json.dumps(
        {x: y for x, y in st.items() if not x.startswith("collectives")})]
    ), st


def _m6_job(torch, cfg):
    """(m6)'s job on both devices: the port's f32 params from seed 7 as
    numpy, prompts, decode tokens and whisper's frames from the seed."""
    import numpy as np

    from repro_torch import tree
    from repro_torch.models import model as mdl
    rng = np.random.default_rng(7)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (M6_B, M6_S))
             .astype(np.int64)}
    if cfg.family == "encdec":
        batch["enc_embeds"] = rng.standard_normal(
            (M6_B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    return {"cfg": cfg, "mesh": MESH_SHAPE, "dtype": torch.float32,
            "params": tree.tree_map(lambda a: a.numpy(), mdl.init_params(
                cfg, 7, dtype=torch.float32, device="cpu")),
            "batch": batch, "cache_len": M6_CACHE,
            "decode_tokens": rng.integers(0, cfg.vocab_size,
                                          (M6_GEN, M6_B, 1)).astype(np.int64)}


def _m6_gates(ranks, at, report):
    """(m6): the card's ranks against the CPU's, every call's logits
    (every row) within M6_TOL of the CPU's largest; every rank's counts
    equal on both devices and to their closed form."""
    from repro_torch.configs import get_smoke
    from repro_torch.launch import sharded
    failures, stats = [], {}
    for arch, i in at.items():
        host, card = ranks[0][i], ranks[0][i + 1]
        tol = M6_TOL.get(get_smoke(arch).family, M6_TOL_DEFAULT)
        gaps = [float((c - h).abs().max()) / max(1.0, float(h.abs().max()))
                for c, h in zip(card["logits_full"], host["logits_full"],
                                strict=True)]
        counts_ok = all(
            sharded.counts_equal(c, e) and sharded.counts_equal(c, hc)
            for r in ranks
            for c, e, hc in zip(r[i + 1]["counts"],
                                r[i + 1]["expected_counts"],
                                r[i]["counts"], strict=True))
        ok = max(gaps) <= tol and counts_ok
        stats[arch] = {"logits_gap_by_call": gaps, "tol": tol,
                       "counts_equal": counts_ok,
                       "k1_launches_card_by_rank": [r[i + 1]["k1_launches"]
                                                    for r in ranks],
                       "k3_launches_card_by_rank": [r[i + 1]["k3_launches"]
                                                    for r in ranks]}
        report(f"(m6) {arch} SMOKE f32 sharded prefill + {M6_GEN} decode "
               f"steps: card ranks vs CPU ranks logits gap by call "
               f"{[f'{g:.2e}' for g in gaps]} (of the CPU's max; tol {tol})"
               f", collectives equal {counts_ok}, K1 / K3 by card rank "
               f"{stats[arch]['k1_launches_card_by_rank']} / "
               f"{stats[arch]['k3_launches_card_by_rank']} -> "
               f"{'OK' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"(m6) {arch}: {stats[arch]}")
    return failures, stats


def _dryrun_start(cfg, B, S):
    """(d): start the dry-run's child (a process of its own: it joins a
    fake process group) while the phase's references and ranks run:
    (m2)'s configuration ``cfg`` over B x S tokens at 2 x 2 in both
    lowerings, then D_FULL at 16 x 16. Returns (executor, futures, start
    time)."""
    import multiprocessing as mp
    from concurrent.futures import ProcessPoolExecutor

    from repro_torch.configs import INPUT_SHAPES, get_config
    from repro_torch.configs.base import InputShape
    from repro_torch.launch import dryrun
    shape = InputShape("m2", S, B, "train")
    ex = ProcessPoolExecutor(1, mp_context=mp.get_context("spawn"))
    futs = {"m2": ex.submit(dryrun.trace_records,
                            [(cfg, shape, {"fsdp_batch": False}),
                             (cfg, shape, {"fsdp_batch": True})], "2x2"),
            "full": ex.submit(dryrun.trace_records,
                              [(get_config(D_FULL[0]),
                                INPUT_SHAPES[D_FULL[1]], {})], "16x16")}
    return ex, futs, time.perf_counter()


def _dryrun_gates(started, ranks, report):
    """(d): the dry-run's (m2) records' collective counts against (m2)'s
    rank 0 in both lowerings; peaks beside (m2)'s measured memory; the
    full-size record printed."""
    from repro_torch.launch import sharded
    ex, futs, t0 = started
    try:
        m2 = futs["m2"].result(timeout=300)
        full = futs["full"].result(timeout=300)
    finally:
        for p in list(getattr(ex, "_processes", {}).values()):
            if p.is_alive() and not all(f.done() for f in futs.values()):
                p.kill()
        ex.shutdown(wait=True, cancel_futures=True)
    wait_s = time.perf_counter() - t0
    failures, stats = [], {"records_m2": m2, "record_full": full[0],
                           "child_wall_s": wait_s}
    for rec, k, mode in ((m2[0], 1, "baseline"), (m2[1], 2, "optimized")):
        step = ranks[0][k]
        same = (sharded.counts_equal(rec["collectives"], step["counts"][0])
                and rec["collectives"]["collective-permute"]["count"] == 0)
        report(f"(d) dry-run of (m2) {mode} at 2 x 2 (rank 0 of a fake "
               f"world of 4, meta tensors): collectives == (m2) rank 0's "
               f"{same}; flops/rank {rec['flops_per_device']:.4e}; "
               f"peak_estimate {rec['memory']['peak_estimate_bytes'] / 2**30:.2f}"
               f" GiB beside (m2)'s measured max_memory_allocated "
               f"{step['max_memory_allocated'] / 2**30:.2f} GiB; trace "
               f"{rec['trace_s']} s -> {'OK' if same else 'FAIL'}")
        if not same:
            failures.append(f"(d) {mode}: {rec['collectives']} vs "
                            f"{step['counts'][0]}")
    report(f"(d) full size: {json.dumps(full[0])}")
    return failures, stats


def phase_mesh(torch, report, workroot):
    """The launch layer on MESH_RANKS ranks that share the card (gloo):
    (m1) expert-parallel MoE at deepseek-v2-lite-16b's full width against
    ``moe_apply``; (m2) the sharded train step in the reference's two
    lowerings (baseline: FSDP over "model", the batch over "data";
    optimized: ``fully_shard``, the batch over every axis, EP, the
    activation spec and gradient shardings) at deepseek-v2-lite-16b's full
    width and 3 layers against the unsharded step from the same weights and
    batch (losses, grad norms, every f32 master), each rank's collective
    bytes by kind equal to their closed form from the spec tree; (m3)
    qwen3-moe's SMOKE config, optimized, f32: the card's ranks against the
    same ranks on the CPU within 1e-5; (m4), (m5) sharded prefill and
    decode (the serve layout: caches split over "model") of
    deepseek-v2-lite-16b at (m2)'s size and qwen3-4b at full width, 2
    layers, against the unsharded runs on the card; (m6) the SMOKE
    configs of falcon-mamba, Jamba, gemma3 (ring) and whisper served,
    card ranks vs CPU ranks; (d) the dry-run of (m2)'s configuration in a
    child process (rank 0 of a fake world, meta tensors), its collective
    counts against (m2)'s rank 0. The unsharded references run first
    in this process and free the card before the ranks start; the ranks
    only load the kernels this process built. Returns (failures, stats)."""
    import numpy as np

    from repro_torch import tree
    from repro_torch.configs import get_config, get_smoke
    from repro_torch.launch import sharded
    from repro_torch.launch.mesh import run_ranks
    from repro_torch.models import model as mdl
    from repro_torch.models import moe as moe_lib

    import gc
    gc.collect()
    torch.cuda.empty_cache()    # the ranks share the card with this process
    failures, stats, wall = [], {}, {}
    t_phase = time.perf_counter()
    d_futures = _dryrun_start(dataclasses.replace(
        get_config("deepseek-v2-lite-16b"), num_layers=M2_LAYERS), M2_B,
        M2_S)
    report(f"mesh: {MESH_RANKS} ranks on a {MESH_SHAPE[0]} x "
           f"{MESH_SHAPE[1]} (data, model) mesh sharing the one card, "
           f"backend {MESH_BACKEND} (every collective on the card's "
           f"tensors); "
           f"predicted wall {MESH_PREDICTED_S:.0f} s")
    full = get_config("deepseek-v2-lite-16b")
    # (m1) the single-process reference
    t0 = time.perf_counter()
    g = torch.Generator(device="cuda")
    g.manual_seed(11)
    mp = moe_lib.moe_init(g, full, torch.bfloat16, device="cuda")
    g.manual_seed(12)
    x = (torch.randn((M1_B, M1_S, full.d_model), generator=g,
                     device="cuda") * 0.3).to(torch.bfloat16)
    m1_ref = {}
    for cf in M1_CAPS:
        moe_lib.reset_dropped()
        y, aux = moe_lib.moe_apply(mp, x, full, capacity_factor=cf)
        m1_ref[cf] = (y.cpu(), float(aux), moe_lib.dropped_count())
    del mp, x, y, aux
    # (m2) the unsharded references: the step at 1.25, the control (the
    # same step on half the batch) and the step at M2_EXACT_CF
    cfg = dataclasses.replace(full, num_layers=M2_LAYERS)
    tokens = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (M2_B, M2_S)).astype(np.int64)
    ref_path = os.path.join(workroot, "mesh_m2_update.pt")
    exact_path = os.path.join(workroot, "mesh_m2_exact_update.pt")
    ref, update = _m2_reference(torch, cfg, tokens, None, path=ref_path)
    ctrl, _ = _m2_reference(torch, cfg, tokens[:M2_B // 2], None,
                            against=update)
    del update, _
    exact_tokens = np.ascontiguousarray(tokens[:, :M2_EXACT_S])
    exact, _ = _m2_reference(torch, cfg, exact_tokens, M2_EXACT_CF,
                             path=exact_path)
    del _
    ctrl_rel = ctrl["update_rel_by_leaf"]
    ctrl_min = min(ctrl_rel, key=ctrl_rel.get)
    report(f"(m2) unsharded reference: {cfg.name} at full width, "
           f"{M2_LAYERS} layers ({ref['params'] / 1e9:.3f} B params), bf16, "
           f"{M2_B} x {M2_S} tokens: losses {ref['losses']}, grad norms "
           f"{ref['grad_norms']}, {ref['seconds']} s/step, dropped "
           f"{ref['dropped']}, update saved in {ref['save_s']:.1f} s, "
           f"max_memory_allocated "
           f"{ref['max_memory_allocated'] / 2**30:.2f} GiB; the control "
           f"(half the batch) reads update rel {ctrl_rel[ctrl_min]:.3f} "
           f"at its least leaf ({ctrl_min}; the limit {M2_UPDATE_RTOL}); "
           f"at capacity {M2_EXACT_CF} over {M2_B} x {M2_EXACT_S} tokens: "
           f"losses {exact['losses']}, dropped {exact['dropped']}")
    # (m4), (m5): the unsharded prefill + decode steps on the card
    m45 = {"m4": _serve_job(torch, cfg, 0,
                            cfg.num_experts / cfg.moe_top_k),
           "m5": _serve_job(torch, dataclasses.replace(
               get_config("qwen3-4b"), num_layers=M5_LAYERS), M5_SEED,
               None)}
    serve_ref = {k: _serve_reference(torch, job) for k, job in m45.items()}
    # (m3) the same inputs for the card's and the CPU's ranks
    scfg = get_smoke(M3_ARCH)
    sp = tree.tree_map(lambda a: a.numpy(), mdl.init_params(
        scfg, 3, dtype=torch.float32, device="cpu"))
    stoks = np.random.default_rng(1).integers(
        0, scfg.vocab_size, (M3_B, M3_S)).astype(np.int64)
    wall["references"] = time.perf_counter() - t0

    m1_job = {"cfg": full, "mesh": MESH_SHAPE, "seed": 11, "x_seed": 12,
              "x_shape": (M1_B, M1_S, full.d_model),
              "dtype": torch.bfloat16, "capacities": list(M1_CAPS)}
    m2_job = {"cfg": cfg, "mesh": MESH_SHAPE, "seed": 0,
              "dtype": torch.bfloat16, "tokens": tokens, "lr": M2_LR,
              "steps": M2_STEPS}
    m2 = {"baseline": dict(m2_job, mode="baseline", reference=ref_path),
          "optimized": dict(m2_job, mode="optimized"),
          "exact": dict(m2_job, mode="optimized", capacity=M2_EXACT_CF,
                        reference=exact_path, tokens=exact_tokens)}
    m3 = {dev: {"cfg": scfg, "mesh": MESH_SHAPE, "mode": "optimized",
                "params": sp, "tokens": stoks, "dtype": torch.float32,
                "steps": 1, "grads": True, "device": dev}
          for dev in ("cuda", "cpu")}
    jobs = [("ep", m1_job), ("step", m2["baseline"]),
            ("step", m2["optimized"]), ("step", m2["exact"]),
            ("step", m3["cuda"]), ("step", m3["cpu"]),
            ("decode", m45["m4"]), ("decode", m45["m5"])]
    m6_at = {}
    for arch in M6_ARCHS:
        host = _m6_job(torch, get_smoke(arch))
        jobs.append(("decode", dict(host, device="cpu",
                                    record_conv=True)))
        jobs.append(("decode", dict(host, device="cuda",
                                    conv_from=len(jobs) - 1)))
        m6_at[arch] = len(jobs) - 2
    t0 = time.perf_counter()
    try:
        ranks = run_ranks(sharded.run_jobs, MESH_RANKS,
                          backend=MESH_BACKEND, device="cuda:0",
                          timeout=MESH_TIMEOUT, args=(jobs,))
    finally:
        for path in (ref_path, exact_path):
            if os.path.exists(path):
                os.remove(path)
    wall["ranks"] = time.perf_counter() - t0
    r0 = ranks[0]

    # (m1)
    ep = r0[0]
    y_ref, aux_ref, drop_ref = m1_ref[8.0]
    y = ep[8.0]["y"]
    rel = float((y.float() - y_ref.float()).norm() / y_ref.float().norm())
    aux_gap = abs(ep[8.0]["aux"] - aux_ref)
    disp = [r[0]["dispatches"] for r in ranks]
    ok = (rel <= M1_REL_TOL and aux_gap <= M1_AUX_TOL
          and all(d[cf] > 0 for d in disp for cf in M1_CAPS)
          and ep["dropped"][8.0] == 0 and drop_ref == 0)
    stats["m1"] = {"rel_err": rel, "aux_gap": aux_gap,
                   "max_abs_err": float((y.float() - y_ref.float()).abs()
                                        .max()),
                   "ep_dispatches_by_rank": [d[8.0] for d in disp],
                   "dropped_ep": ep["dropped"],
                   "dropped_moe_apply": {cf: m1_ref[cf][2] for cf in M1_CAPS},
                   "ep_seconds": ep["seconds"]}
    report(f"(m1) EP MoE {full.name} full width ({full.num_experts} "
           f"experts, top-{full.moe_top_k}, {full.num_shared_experts} shared,"
           f" {full.num_experts // MESH_SHAPE[1]} a rank), bf16, {M1_B} x "
           f"{M1_S} tokens: capacity 8 vs moe_apply rel {rel:.3e} (tol "
           f"{M1_REL_TOL}), aux {aux_gap:.2e} (tol {M1_AUX_TOL}), EP "
           f"dispatches by rank {[d[8.0] for d in disp]}; dropped at 1.25: "
           f"EP {ep['dropped'][1.25]} of {M1_B * M1_S * full.moe_top_k}, "
           f"moe_apply {m1_ref[1.25][2]} -> {'OK' if ok else 'FAIL'}")
    if not ok:
        failures.append(f"(m1) EP MoE: {stats['m1']}")

    # (m2)
    refs = {"baseline": ref, "optimized": ref, "exact": exact}
    for k, mode in ((1, "baseline"), (2, "optimized"), (3, "exact")):
        rs = [r[k] for r in ranks]
        a, rf = rs[0], refs[mode]
        steps = len(rf["losses"])
        loss_gap = max(abs(a["losses"][i] - rf["losses"][i])
                       / rf["losses"][i] for i in range(steps))
        gn_gap = max(abs(a["grad_norms"][i] - rf["grad_norms"][i])
                     / rf["grad_norms"][i] for i in range(steps))
        counts_ok = all(sharded.counts_equal(c, e) for r in rs
                        for c, e in zip(r["counts"], r["expected_counts"],
                                        strict=True))
        same = all(r["losses"] == a["losses"] for r in rs)
        ep_ok = (a["use_ep"] == (mode != "baseline")
                 and (min(r["ep_dispatches"] for r in rs) > 0)
                 == (mode != "baseline"))
        k1 = [r["k1_launches"] for r in rs]
        ok = (loss_gap <= M2_LOSS_RTOL[mode] and gn_gap <= M2_GN_RTOL[mode]
              and counts_ok and same and ep_ok and len(a["losses"]) == steps
              and all(f > 0 and b > 0 for f, b in k1))
        st = {"losses": a["losses"], "grad_norms": a["grad_norms"],
              "loss_rel_gap": loss_gap, "grad_norm_rel_gap": gn_gap,
              "s_per_step_by_rank": [r["seconds"] for r in rs],
              "max_memory_allocated_by_rank": [r["max_memory_allocated"]
                                               for r in rs],
              "collectives_step1_rank0": a["counts"][0],
              "collectives_closed_form_rank0": a["expected_counts"][0],
              "counts_equal_closed_form": counts_ok,
              "batch_axes": a["batch_axes"], "use_ep": a["use_ep"],
              "ep_dispatches_by_rank": [r["ep_dispatches"] for r in rs],
              "ep_dropped": sum(r["ep_dropped"] for r in rs),
              "k1_launches_by_rank": k1,
              "job_seconds": max(r["job_seconds"] for r in rs)}
        upd = ""
        if "update_sq" in a:
            # each leaf's relative norm over every rank's shard (a leaf
            # replicated on some axis is counted once a replica in both
            # sums, so the ratio holds)
            sq = [[sum(r["update_sq"][j][i] for r in rs) for i in (0, 1)]
                  for j in range(len(a["update_leaves"]))]
            rel = {n: math.sqrt(d / w) if w else math.inf
                   for n, (d, w) in zip(a["update_leaves"], sq)}
            worst = max(rel, key=rel.get)
            ok = (ok and rel[worst] <= M2_UPDATE_RTOL
                  and ctrl_rel[ctrl_min] > M2_UPDATE_RTOL)
            st["update_rel_by_leaf"] = rel
            upd = (f"updates rel {rel[worst]:.3f} at the worst leaf "
                   f"({worst}; tol {M2_UPDATE_RTOL}), ")
        if mode == "exact":
            ok = ok and st["ep_dropped"] == 0 and rf["dropped"] == 0
            upd += f"dropped {st['ep_dropped']} / {rf['dropped']}, "
        stats[f"m2_{mode}"] = st
        gb = {kind: round(v["result_bytes"] / 1e9, 4)
              for kind, v in a["counts"][0].items()}
        report(f"(m2) {mode}: batch over {a['batch_axes']}, EP "
               f"{a['use_ep']}; losses {a['losses']} vs {rf['losses']} "
               f"(rel {loss_gap:.2e}, tol {M2_LOSS_RTOL[mode]}), grad norms "
               f"rel {gn_gap:.2e} (tol {M2_GN_RTOL[mode]}), {upd}"
               f"collectives == closed form {counts_ok}; s/step by rank "
               f"{[[round(t, 3) for t in r['seconds']] for r in rs]}; "
               f"max_memory_allocated by rank "
               f"{[round(r['max_memory_allocated'] / 2**30, 2) for r in rs]}"
               f" GiB; rank 0 result GB by kind a step {gb}; K1 launches "
               f"(fwd, bwd) by rank {k1} -> {'OK' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"(m2) {mode}: " + json.dumps(
                {k: v for k, v in st.items() if k != "update_rel_by_leaf"}))

    # (m3)
    card, host = r0[4], r0[5]
    loss_gap = abs(card["losses"][0] - host["losses"][0])
    grad_gap = max(float((a - b).abs().max()) / max(1.0, float(
        b.abs().max())) for a, b in zip(tree.leaves(card["grads"]),
                                         tree.leaves(host["grads"])))
    ok = (loss_gap <= M3_TOL and grad_gap <= M3_TOL and card["use_ep"]
          and sharded.counts_equal(card["counts"][0], host["counts"][0]))
    stats["m3"] = {"loss_gap": loss_gap, "grad_gap_scaled": grad_gap,
                   "loss_card": card["losses"][0],
                   "loss_cpu": host["losses"][0]}
    report(f"(m3) {scfg.name} optimized (EP), f32, {M3_B} x {M3_S}: card "
           f"ranks vs CPU ranks loss {loss_gap:.3e}, gradients "
           f"{grad_gap:.3e} (of each leaf's max; tol {M3_TOL}) -> "
           f"{'OK' if ok else 'FAIL'}")
    if not ok:
        failures.append(f"(m3) card vs CPU: {stats['m3']}")

    # (m4), (m5)
    for k, key in ((6, "m4"), (7, "m5")):
        f, stats[key] = _serve_gates(ranks, k, key, m45[key],
                                     serve_ref[key], report)
        failures += f
    # (m6)
    f, stats["m6"] = _m6_gates(ranks, m6_at, report)
    failures += f
    # (d)
    f, stats["d"] = _dryrun_gates(d_futures, ranks, report)
    failures += f

    stats["launches"] = {
        f"train_{mode}": {f"k1_{d}": sum(r[k]["k1_launches"][i]
                                         for r in ranks)
                          for i, d in enumerate(("fwd", "bwd"))}
        for k, mode in ((1, "baseline"), (2, "optimized"), (3, "exact"))}
    stats["launches"].update({
        f"serve_{key}": {"k1_fwd": sum(r[k]["k1_launches"] for r in ranks)}
        for k, key in ((6, "m4"), (7, "m5"))})
    # (m3) holds the card against the CPU, as gate (w) does: its launches
    # are a gate's, not the path's
    stats["m3"]["k1_launches_card"] = [sum(r[4]["k1_launches"][i]
                                           for r in ranks) for i in (0, 1)]
    stats["reference"] = {"step": ref, "control": ctrl, "exact": exact}
    wall["phase"] = time.perf_counter() - t_phase
    stats["wall_s"] = wall
    stats["predicted_wall_s"] = MESH_PREDICTED_S
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
    ap.add_argument("--phases",
                    default="kernels,serve,train,dp,mamba,entry,archs,"
                            "hybrid,mesh",
                    help="comma list of: kernels, serve, train, dp, mamba, "
                         "entry, archs, hybrid, mesh")
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
        failures += k1_refusals(torch, fa)
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
    # 8. entry
    estats = {}
    if "entry" in phases:
        t0 = time.perf_counter()
        f, estats = phase_entry(torch, fa, fad, report, workroot)
        failures += f
        report(f"entry ({smi}): CLI in memory "
               f"{estats['cli']['s_per_step']:.4f} s/step, "
               f"{estats['cli']['tokens_per_s']:.0f} tokens/s, "
               f"max_memory_allocated "
               f"{estats['cli']['max_memory_allocated'] / 2**30:.2f} GiB; "
               f"CLI --offload {estats['cli_offload']['s_per_step']:.3f} "
               f"s/step, {estats['cli_offload']['tokens_per_s']:.0f} "
               f"tokens/s, max_memory_allocated "
               f"{estats['cli_offload']['max_memory_allocated'] / 2**30:.2f}"
               f" GiB; examples "
               + json.dumps({k: round(v["seconds"], 1)
                             for k, v in estats["examples"].items()}))
        report("entry stats: " + json.dumps(estats))
        wall["entry"] = time.perf_counter() - t0
    # 9. archs
    astats = {}
    if "archs" in phases:
        t0 = time.perf_counter()
        f, astats = phase_archs(torch, fa, report, workroot)
        failures += f
        report("archs stats: " + json.dumps(astats))
        wall["archs"] = time.perf_counter() - t0
    # 10. hybrid
    hstats = {}
    if "hybrid" in phases:
        t0 = time.perf_counter()
        f, hstats = phase_hybrid(torch, fa, report)
        failures += f
        g, t = hstats["generate"], hstats["train"]
        report(f"hybrid ({smi}): {g['model']} at {g['layers']} layers decode "
               f"{g['decode_tokens_per_s']:.1f} tokens/s (card busy "
               f"{100 * g['decode_2_steps_busy']['busy_share']:.1f} % of two "
               f"steps), MoE dropped {g['moe_dropped_first_prefill']} of "
               f"{g['moe_assignments_first_prefill']}; trained at "
               f"{t['layers']} layers {t['s_per_step']:.3f} s/step, "
               f"{t['tokens_per_s']:.0f} tokens/s, "
               f"{t['max_memory_allocated'] / 2**30:.2f} GiB")
        report("hybrid stats: " + json.dumps(hstats))
        wall["hybrid"] = time.perf_counter() - t0
    # 11. mesh
    xstats = {}
    if "mesh" in phases:
        t0 = time.perf_counter()
        f, xstats = phase_mesh(torch, report, workroot)
        failures += f
        report(f"mesh ({smi}): wall {xstats['wall_s']['phase']:.1f} s "
               f"(predicted {MESH_PREDICTED_S:.0f} s; references "
               f"{xstats['wall_s']['references']:.1f} s, ranks "
               f"{xstats['wall_s']['ranks']:.1f} s, the dry-run's child "
               f"{xstats['d']['child_wall_s']:.1f} s from the phase's "
               f"start); sharded serving s by call (rank 0): (m4) "
               f"{[round(t, 3) for t in xstats['m4']['seconds_by_rank'][0]]}"
               f", (m5) "
               f"{[round(t, 3) for t in xstats['m5']['seconds_by_rank'][0]]}")
        report("mesh stats: " + json.dumps(xstats, default=str))
        wall["mesh"] = time.perf_counter() - t0
    report("phase wall seconds: " + json.dumps(wall))

    if failures:
        for msg in failures:
            print(f"FAIL: {msg}", file=sys.stderr)
        return 1

    # the train phase's two runs (recompute, then spill), the dp phase's
    # run and the entry phase's two CLI runs are the training main paths
    tr = tstats.get("launches", {})
    ts = tstats.get("spill", {}).get("launches", {})
    td = dstats.get("launches", {})
    te = estats.get("cli", {}).get("launches", {})
    to = estats.get("cli_offload", {}).get("launches", {})
    tg = astats.get("train_gemma3", {}).get("launches", {})
    tq = astats.get("train_deepseek", {}).get("launches", {})
    tw = astats.get("whisper", {}).get("train", {}).get("launches", {})
    tv = astats.get("internvl2", {}).get("train", {}).get("launches", {})
    tj = hstats.get("train", {}).get("launches", {})
    xm = xstats.get("launches", {})
    tl = {k: sum(d.get(k, 0) for d in (tr, ts, td, te, to, tg, tq, tw, tv,
                                       tj, *xm.values()))
          for k in ("k1_fwd", "k1_bwd", "k2")}
    mesh_k1 = {k1: {f"mesh_{p}": v.get(k1, 0) for p, v in xm.items()}
               for k1 in ("k1_fwd", "k1_bwd")}
    serve_k1 = stats.get("k1_launches", 0)
    arch_k1 = {"archs_serve_gemma3": astats.get("serve_gemma3", {}).get(
                   "k1_launches", 0),
               "archs_generate_deepseek": astats.get(
                   "generate_deepseek", {}).get("k1_launches", 0),
               "archs_generate_qwen3_moe": astats.get(
                   "generate_qwen3_moe", {}).get("k1_launches", 0),
               "archs_generate_whisper": astats.get("whisper", {}).get(
                   "generate", {}).get("k1_launches", 0),
               "archs_generate_internvl2": astats.get("internvl2", {}).get(
                   "generate", {}).get("k1_launches", 0),
               "hybrid_generate_jamba": hstats.get("generate", {}).get(
                   "k1_launches", 0)}
    k3_paths = {"mamba": mstats.get("k3_launches", 0),
                "hybrid_generate_jamba": hstats.get("generate", {}).get(
                    "k3_launches", 0),
                "hybrid_train_jamba": tj.get("k3", 0)}
    kernels = [
        _kernel_entry("K1 flash_attention_fwd",
                      "src/repro_torch/csrc/flash_attention_fwd.cu",
                      "src/repro/kernels/flash_attention.py:27",
                      serve_k1 + sum(arch_k1.values()) + tl["k1_fwd"],
                      rows, HEADLINE, smi,
                      launches_by_path={
                          "serve": serve_k1, **arch_k1,
                          "archs_train_gemma3": tg.get("k1_fwd", 0),
                          "archs_train_deepseek": tq.get("k1_fwd", 0),
                          "archs_train_whisper": tw.get("k1_fwd", 0),
                          "archs_train_internvl2": tv.get("k1_fwd", 0),
                          "hybrid_train_jamba": tj.get("k1_fwd", 0),
                          "train_recompute": tr.get("k1_fwd", 0),
                          "train_spill": ts.get("k1_fwd", 0),
                          "train_dp": td.get("k1_fwd", 0),
                          "entry_cli": te.get("k1_fwd", 0),
                          "entry_cli_offload": to.get("k1_fwd", 0),
                          **mesh_k1["k1_fwd"]}),
        _kernel_entry("K1 flash_attention_bwd",
                      "src/repro_torch/csrc/flash_attention_bwd.cu",
                      "src/repro/models/attention.py:105",
                      tl["k1_bwd"], brows, K1B_HEADLINE, smi,
                      launches_by_path={
                          "train_recompute": tr.get("k1_bwd", 0),
                          "train_spill": ts.get("k1_bwd", 0),
                          "train_dp": td.get("k1_bwd", 0),
                          "entry_cli": te.get("k1_bwd", 0),
                          "entry_cli_offload": to.get("k1_bwd", 0),
                          "archs_train_gemma3": tg.get("k1_bwd", 0),
                          "archs_train_deepseek": tq.get("k1_bwd", 0),
                          "archs_train_whisper": tw.get("k1_bwd", 0),
                          "archs_train_internvl2": tv.get("k1_bwd", 0),
                          "hybrid_train_jamba": tj.get("k1_bwd", 0),
                          **mesh_k1["k1_bwd"]}),
        _kernel_entry("K2 fused_adam", "src/repro_torch/csrc/fused_adam.cu",
                      "src/repro/kernels/fused_adam.py:27",
                      tl["k2"], arows, K2_HEADLINE, smi,
                      launches_by_path={
                          "train_recompute": tr.get("k2", 0),
                          "train_spill": ts.get("k2", 0),
                          "train_dp": td.get("k2", 0),
                          "entry_cli": te.get("k2", 0),
                          "entry_cli_offload": to.get("k2", 0),
                          "hybrid_train_jamba": tj.get("k2", 0)}),
        _kernel_entry("K3 selective_scan_fwd",
                      "src/repro_torch/csrc/selective_scan.cu",
                      "src/repro/kernels/selective_scan.py:27",
                      sum(k3_paths.values()), srows, K3_HEADLINE, smi,
                      launches_by_path=k3_paths,
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
