#!/usr/bin/env python3
"""Time variants of K3 (``src/repro_torch/csrc/selective_scan.cu``) on one
CUDA card, to show where the kernel's time goes.

Each variant is the kernel's source with a few text substitutions (a
constant changed, a part of the chunk loop dropped), built with the
port's ``nvcc`` flags into ``_work/k3_variants/`` and timed against the
unchanged source at falcon-mamba-7b's prefill shape (B = 1 and 2, S =
2048, d_inner 8192, state 16; bf16 x, B, C as column slices of one
projection at offset dt_rank; f32 dt, A, D), in interleaved rounds with
CUDA events. Variants that drop work give wrong results on purpose: they
show what that work costs. Prints one line per (variant, B) and a last
JSON line with every number, the card's name and power limit.

    python3 tools/k3_variants.py
    python3 tools/k3_variants.py --only no_steps,element_bc
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

CU = ROOT / "src/repro_torch/csrc/selective_scan.cu"
OUT = ROOT / "_work/k3_variants"
STEPS = "#pragma unroll\n    for (int t = 0; t < TC; t += U) {"
CHUNK_IO = ("    fill(i + STAGES - 1);                   // into chunk i - 1's "
            "stage\n    if (i + 1 < nch) load_bc(i + 1);\n"
            "    if (i > 0) write_y(i - 1);\n")
STORE_BC = "    if (i + 1 < nch) store_bc(buf ^ 1);\n"
LAST = ("  return launch<T, 4, 4>(x, dt, A, Bc, Cc, D, y, hout, batch, a, "
        "stream);\n}")

#: name -> (what it shows, [(text in the source, its replacement)])
VARIANTS = {
    "no_steps": ("the chunk loop without its steps: the copies, B/C loads, "
                 "y write-back and barriers alone",
                 [(STEPS, STEPS.replace("t < TC", "t < 0"))]),
    "no_chunk_io": ("the steps alone: no copies, B/C loads or y write-back",
                    [(CHUNK_IO, ""), (STORE_BC, "")]),
    "element_bc": ("B and C loaded element by element, as for unaligned "
                   "slices",
                   [("  a.bc_vec = unpadded", "  a.bc_vec = 0 && unpadded")]),
    "cap4": ("registers capped for four blocks per SM (128 a thread at "
             "state 16)",
             [("__launch_bounds__(CH * L)", "__launch_bounds__(CH * L, 4)")]),
    "U8": ("the exps of 8 steps ahead of the recurrence, not 4",
           [("constexpr int U = 4;", "constexpr int U = 8;")]),
    "K2L8": ("two states a thread, 8 lanes a channel at state 16 (twice the "
             "warps), 8 steps ahead",
             [(LAST, LAST.replace("4, 4", "2, 8")),
              ("constexpr int U = 4;", "constexpr int U = 8;")]),
    "CH16": ("16 channels a block, not 32",
             [("constexpr int CH = 32;", "constexpr int CH = 16;")]),
    "TC16": ("chunks of 16 steps, not 32",
             [("constexpr int TC = 32;", "constexpr int TC = 16;")]),
}


def build(names):
    """Write and compile every variant (one ``nvcc`` each, all at once);
    returns name -> (ctypes function, registers, largest spill)."""
    from repro_torch.kernels import _build
    OUT.mkdir(parents=True, exist_ok=True)
    src = CU.read_text()
    procs = {}
    for name in names:
        text = src
        for old, new in ([] if name == "base" else VARIANTS[name][1]):
            if text.count(old) != 1:
                raise SystemExit(f"{name}: the source no longer holds "
                                 f"{old!r}")
            text = text.replace(old, new)
        (OUT / f"{name}.cu").write_text(text)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o",
               str(OUT / f"{name}.so"), str(OUT / f"{name}.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    built = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"{name}: nvcc failed\n{log}")
        f = ctypes.CDLL(str(OUT / f"{name}.so")).selective_scan_fwd
        f.restype = ctypes.c_int
        f.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 4
                      + [ctypes.c_longlong] * 4 + [ctypes.c_int,
                                                   ctypes.c_void_p])
        regs = [int(r) for r in re.findall(r"Used (\d+) registers", log)]
        spill = max(int(s) for s in re.findall(r"(\d+) bytes spill", log))
        built[name] = (f, regs, spill)
    return built


def inputs(torch, B, S=2048, di=8192, st=16, dt_rank=256):
    g = torch.Generator(device="cuda").manual_seed(B)
    x = (torch.randn(B, S, di, device="cuda", generator=g) * 0.5).bfloat16()
    proj = torch.randn(B, S, dt_rank + 2 * st, device="cuda",
                       generator=g).bfloat16()
    dt = torch.nn.functional.softplus(
        torch.randn(B, S, di, device="cuda", generator=g) * 0.5 - 4.0)
    A = -torch.arange(1, st + 1, dtype=torch.float32,
                      device="cuda")[None].repeat(di, 1)
    D = torch.ones(di, device="cuda")
    return (x, dt, A, proj[..., dt_rank:dt_rank + st],
            proj[..., dt_rank + st:], D)


def launch(torch, f, ins, out):
    x, dt, A, Bc, Cc, D = ins
    y, h = out
    B, S, di = x.shape
    err = f(x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bc.data_ptr(),
            Cc.data_ptr(), D.data_ptr(), y.data_ptr(), h.data_ptr(), B, S,
            di, A.shape[1], Bc.stride(0), Bc.stride(1), Cc.stride(0),
            Cc.stride(1), 1, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"launch failed: cudaError {err}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", default=",".join(VARIANTS),
                    help="comma list of variants (the base always runs)")
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("k3_variants: no CUDA device", file=sys.stderr)
        return 1
    names = ["base"] + [n for n in args.only.split(",") if n]
    built = build(names)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    result = {"card": smi, "variants": {}}
    for B in (1, 2):
        ins = inputs(torch, B)
        x, A = ins[0], ins[2]
        outs = {n: (torch.empty_like(x),
                    torch.empty(B, x.shape[2], A.shape[1], device="cuda"))
                for n in names}
        times = {n: [] for n in names}
        for _ in range(args.rounds):          # interleaved: drift-immune
            for n in names:
                f = built[n][0]
                for _ in range(3):
                    launch(torch, f, ins, outs[n])
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
                for _ in range(args.reps):
                    launch(torch, f, ins, outs[n])
                e1.record()
                torch.cuda.synchronize()
                times[n].append(e0.elapsed_time(e1) / args.reps)
        y0, h0 = outs["base"]
        for n in names:
            t = sorted(times[n])
            y, h = outs[n]
            row = {"ms_median": t[len(t) // 2], "ms_min": t[0],
                   "ms_max": t[-1],
                   "max_abs_diff_y": (y.float() - y0.float()).abs().max()
                   .item(),
                   "max_abs_diff_h": (h - h0).abs().max().item(),
                   "registers": built[n][1], "max_spill": built[n][2],
                   "what": "unchanged" if n == "base" else VARIANTS[n][0]}
            result["variants"].setdefault(n, {})[f"B={B}"] = row
            print(f"B={B} {n:12s} {row['ms_median']:.4f} ms (min "
                  f"{row['ms_min']:.4f}, max {row['ms_max']:.4f}), |dy| "
                  f"{row['max_abs_diff_y']:.3e}, spill {row['max_spill']}",
                  flush=True)
    print(smi)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
