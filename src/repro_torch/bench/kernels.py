"""Kernel microbenchmarks of the port: each hand-written Hopper kernel
(K1 flash-attention forward and backward, K2 fused Adam, K3 selective
scan) against its plain PyTorch version on the card, within the
tolerances ``chip_smoke.py`` holds them to, and timed beside it with
CUDA events after a warm-up.

    python -m repro_torch.bench.kernels                 # on the card
    python -m repro_torch.bench.kernels --device cpu    # plain versions

The shapes are the reference benchmark's (``benchmarks/bench_kernels.py``),
plus K1 in bf16 at GPT-100M's training shape. On the CPU no kernel runs:
each plain version is checked against dense textbook math on the same
inputs and timed on the host clock, and the rows say so.

``main(argv)`` returns ``{row name: {"max_abs_err", "tol", "ok", "ms",
"plain_ms", ...}}``; run as a script it exits 1 when a row fails.
"""
from __future__ import annotations

import argparse
import math
import sys
from typing import Dict, List, Optional

import torch

from repro_torch import resolve_device
from repro_torch.bench.common import Reporter, cuda_ms, time_call
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import fused_adam as fad
from repro_torch.kernels import selective_scan as k3

#: K1's elementwise tolerance (atol = rtol), and its bound on
#: ||out - want|| / ||want|| (chip_smoke.py's TOL and REL_TOL)
K1_TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-5}
K1_REL_TOL = 1e-2
#: K2's absolute tolerances on p', m', v' and the bf16 copy, plus 1e-7
#: relative (tests/test_kernels.py's)
K2_TOL = (1e-6, 1e-7, 1e-7, 2e-2)
#: K3's y tolerance (f32) and h's, relative to max |h|
K3_TOL, K3_H_RTOL = 1e-4, 1e-4

# (label, B, H, S, hd, dtype): the reference's f32 shape, then
# GPT-100M's training shape (batch 16 x 256 tokens, 12 heads of 64)
K1_CASES = [("f32 (1,4,256,64)", 1, 4, 256, 64, torch.float32),
            ("gpt-100m bf16 (16,12,256,64)", 16, 12, 256, 64,
             torch.bfloat16)]
K3_CASE = (2, 128, 64, 8)          # (B, S, d_inner, state)
K2_N = 1 << 14


def _dense_attention(q, k, v):
    """Textbook causal softmax attention in f32 (the CPU check of K1)."""
    S = q.shape[2]
    s = (q.float() @ k.float().transpose(-1, -2)) / math.sqrt(q.shape[-1])
    mask = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
    p = torch.softmax(s.masked_fill(~mask, float("-inf")), dim=-1)
    return p @ v.float()


def _dense_scan(x, dt, A, Bc, Cc, D):
    """The selective-scan recurrence one step at a time (the CPU check
    of K3)."""
    B, S, di = x.shape
    h = torch.zeros(B, di, A.shape[-1])
    ys = []
    for t in range(S):
        h = (torch.exp(dt[:, t, :, None] * A) * h
             + (dt[:, t] * x[:, t])[..., None] * Bc[:, t, None, :])
        ys.append((h * Cc[:, t, None, :]).sum(-1) + D * x[:, t])
    return torch.stack(ys, 1), h


def _within(got, want, atol, rtol=0.0) -> bool:
    d = (got.float() - want.float()).abs()
    return bool(torch.isfinite(got.float()).all()) and bool(
        (d <= atol + rtol * want.float().abs()).all())


def _max_err(got, want) -> float:
    return (got.float() - want.float()).abs().max().item()


def _timing(on_card: bool, fn, plain, reps: int) -> Dict[str, object]:
    """The kernel's and the plain version's ms: CUDA events on the card;
    on the CPU only the plain version, on the host clock."""
    if on_card:
        return {"ms": cuda_ms(fn, reps),
                "plain_ms": cuda_ms(plain, max(2, reps // 5), warmup=1)}
    return {"ms": None, "plain_ms_cpu_host": time_call(plain) * 1e3}


def bench_k1(dev, on_card: bool) -> List[dict]:
    rows = []
    for label, B, H, S, hd, dt in K1_CASES:
        g = torch.Generator(device=dev).manual_seed(len(rows))
        q, k, v, do = (torch.randn(B, H, S, hd, device=dev, generator=g)
                       .to(dt) for _ in range(4))
        tol = K1_TOL[dt]
        # forward
        if on_card:
            got, lse = fa.flash_attention_fwd(q, k, v, causal=True)
            want, want_lse = fa.flash_attention_plain(q, k, v, causal=True)
        else:
            got, lse = fa.flash_attention_plain(q, k, v, causal=True)
            want = _dense_attention(q, k, v)
        rel = ((got.float() - want.float()).norm()
               / want.float().norm()).item()
        ok = _within(got, want, tol, tol) and rel <= K1_REL_TOL
        rows.append({"name": f"k1_fwd {label}", "max_abs_err":
                     _max_err(got, want), "rel_err": rel, "tol": tol,
                     "ok": ok, **_timing(
                         on_card,
                         lambda: fa.flash_attention_fwd(q, k, v),
                         lambda: fa.flash_attention_plain(q, k, v), 20)})
        # backward, from the forward's own out and lse
        out = got
        if on_card:
            grads = fa.flash_attention_bwd(q, k, v, out, do, lse)
            wants = fa.flash_attention_bwd_plain(q, k, v, out, do, lse)
        else:
            grads = fa.flash_attention_bwd_plain(q, k, v, out, do, lse)
            leaves = [t.detach().float().requires_grad_() for t in (q, k, v)]
            wants = torch.autograd.grad(_dense_attention(*leaves), leaves,
                                        do.float())
        err = max(_max_err(a, w) for a, w in zip(grads, wants))
        rel = max(((a.float() - w.float()).norm() / w.float().norm()).item()
                  for a, w in zip(grads, wants))
        ok = all(_within(a, w, tol, tol) for a, w in zip(grads, wants)) \
            and rel <= K1_REL_TOL
        rows.append({"name": f"k1_bwd {label}", "max_abs_err": err,
                     "rel_err": rel, "tol": tol, "ok": ok, **_timing(
                         on_card,
                         lambda: fa.flash_attention_bwd(q, k, v, out, do, lse),
                         lambda: fa.flash_attention_bwd_plain(
                             q, k, v, out, do, lse), 10)})
    return rows


def bench_k2(dev, on_card: bool) -> dict:
    from repro_torch.optim.adam import AdamConfig, _adam_update
    g = torch.Generator(device=dev).manual_seed(20)
    p, gr = (torch.randn(K2_N, device=dev, generator=g) for _ in range(2))
    m = torch.zeros(K2_N, device=dev)
    v = torch.zeros(K2_N, device=dev)
    if on_card:
        got = fad.fused_adam(p, m, v, gr, 1)
        want = fad.fused_adam_plain(p, m, v, gr, 1)
    else:
        got = fad.fused_adam_plain(p, m, v, gr, 1)
        p2, m2, v2 = _adam_update(p, gr, m, v, 1, AdamConfig(lr=1e-3))
        want = (p2, m2, v2, p2.to(torch.bfloat16))
    ok = all(_within(a, w, tol, 1e-7)
             for a, w, tol in zip(got, want, K2_TOL))
    return {"name": f"fused_adam n={K2_N} f32 step 1",
            "max_abs_err": max(_max_err(a, w) for a, w in zip(got[:3],
                                                              want[:3])),
            "tol": list(K2_TOL), "ok": ok, **_timing(
                on_card, lambda: fad.fused_adam(p, m, v, gr, 1),
                lambda: fad.fused_adam_plain(p, m, v, gr, 1), 100)}


def bench_k3(dev, on_card: bool) -> dict:
    B, S, di, st = K3_CASE
    g = torch.Generator(device=dev).manual_seed(10)
    x = torch.randn(B, S, di, device=dev, generator=g)
    dt = torch.nn.functional.softplus(
        torch.randn(B, S, di, device=dev, generator=g)) * 0.1
    A = -torch.exp(torch.randn(di, st, device=dev, generator=g))
    Bc, Cc = (torch.randn(B, S, st, device=dev, generator=g)
              for _ in range(2))
    D = torch.randn(di, device=dev, generator=g)
    if on_card:
        y, h = k3.selective_scan_fwd(x, dt, A, Bc, Cc, D)
        yw, hw = k3.selective_scan_plain(x, dt, A, Bc, Cc, D)
    else:
        y, h = k3.selective_scan_plain(x, dt, A, Bc, Cc, D)
        yw, hw = _dense_scan(x, dt, A, Bc, Cc, D)
    h_rel = _max_err(h, hw) / hw.abs().max().item()
    ok = _within(y, yw, K3_TOL) and h_rel <= K3_H_RTOL
    return {"name": f"selective_scan f32 (B,S,di,st)=({B},{S},{di},{st})",
            "max_abs_err": _max_err(y, yw), "h_max_rel_err": h_rel,
            "tol": K3_TOL, "ok": ok, **_timing(
                on_card, lambda: k3.selective_scan_fwd(x, dt, A, Bc, Cc, D),
                lambda: k3.selective_scan_plain(x, dt, A, Bc, Cc, D), 50)}


def run(device, rep: Optional[Reporter] = None) -> Dict[str, dict]:
    rep = rep or Reporter()
    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    if on_card:
        rep.section(f"kernels on {torch.cuda.get_device_name(dev)}: each "
                    "kernel against its plain version, CUDA-event ms")
    else:
        rep.section(f"{dev.type}: no kernel runs; each plain version "
                    "against dense math, host-clock ms of the plain "
                    "version on this CPU (not a kernel time)")
    rows = bench_k1(dev, on_card) + [bench_k2(dev, on_card),
                                     bench_k3(dev, on_card)]
    out = {}
    for r in rows:
        name = r.pop("name")
        out[name] = r
        if on_card:
            derived = (f"kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f}"
                       f" ms, tol {r['tol']}")
        else:
            derived = (f"kernel not run on the CPU; plain version "
                       f"{r['plain_ms_cpu_host']:.2f} ms on the CPU host "
                       f"clock, tol {r['tol']}")
        rep.add(f"kernels/{name.replace(' ', '_')}_maxerr",
                f"{r['max_abs_err']:.2e}",
                f"{derived} -> {'OK' if r['ok'] else 'FAIL'}")
    return out


def main(argv: Optional[List[str]] = None) -> Dict[str, dict]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (plain versions only)")
    args = ap.parse_args(argv)
    return run(args.device)


if __name__ == "__main__":
    sys.exit(0 if all(r["ok"] for r in main().values()) else 1)
