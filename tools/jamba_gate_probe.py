#!/usr/bin/env python3
"""Where jamba-v0.1-52b's decode parts from a fresh prefill, step by step,
on one CUDA card.

``chip_smoke.py``'s gate (z1) holds only the last of 16 greedy decode
steps against a fresh prefill over prompt + generated tokens (one
8-layer block at full width, random seed-0 weights, 2 prompts of 1024
tokens, the MoE at capacity factor E / K, caches grown one slot a step).
This tool holds every step against its own fresh prefill,
||decode - prefill|| / ||prefill||, in three settings: bf16; bf16 with a
dense MLP in place of each MoE layer (no router); f32. Spikes that do
not carry to the next step, present with the router and absent without
it, are router choices that tie within the two paths' rounding; a cache
fault would carry. Prints one line per setting and a last JSON line with
every number, the card's name and power limit.

    python3 tools/jamba_gate_probe.py
"""
from __future__ import annotations

import dataclasses
import functools
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

B, S, GEN, LAYERS = 2, 1024, 16, 8


def per_step_rel(torch, cfg, dtype):
    """Every decode step's logits against a fresh prefill's last logits."""
    from chip_smoke import grow_caches
    from repro_torch.data import SyntheticLM
    from repro_torch.models import model as mdl
    from repro_torch.models import moe, moe_ep
    torch.cuda.empty_cache()
    params = mdl.init_params(cfg, 0, dtype=dtype)
    prompt = torch.from_numpy(SyntheticLM(cfg.vocab_size, seed=0).batch(
        B, S)).long().cuda()
    real = moe_ep.moe_dispatch
    if cfg.num_experts:
        moe_ep.moe_dispatch = functools.partial(
            moe.moe_apply, capacity_factor=cfg.num_experts / cfg.moe_top_k)
    try:
        caches = mdl.init_caches(cfg, B, S, dtype)
        logits, caches = mdl.prefill(params, cfg, {"tokens": prompt}, caches)
        toks, rels = [logits.argmax(-1)], []
        for i in range(GEN):
            caches = grow_caches(torch, mdl, cfg, caches, S + i + 1, B,
                                 dtype)
            logits, caches = mdl.decode_step(params, cfg, toks[-1][:, None],
                                             S + i, caches)
            toks.append(logits.argmax(-1))
            full = torch.cat([prompt] + [t[:, None] for t in toks[:-1]], 1)
            want, _ = mdl.prefill(params, cfg, {"tokens": full},
                                  mdl.init_caches(cfg, B, full.shape[1],
                                                  dtype))
            rels.append(float((logits.float() - want.float()).norm()
                              / want.float().norm()))
    finally:
        moe_ep.moe_dispatch = real
    del params, caches
    return rels


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("jamba_gate_probe: no CUDA device", file=sys.stderr)
        return 1
    from chip_smoke import nvidia_smi_line
    from repro_torch.configs import get_config
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = nvidia_smi_line()
    cfg = dataclasses.replace(get_config("jamba-v0.1-52b"),
                              num_layers=LAYERS)
    settings = {"bf16": (cfg, torch.bfloat16),
                "bf16 dense MLP for MoE": (
                    dataclasses.replace(cfg, num_experts=0), torch.bfloat16),
                "f32": (cfg, torch.float32)}
    out = {}
    for name, (c, dtype) in settings.items():
        t0 = time.perf_counter()
        out[name] = per_step_rel(torch, c, dtype)
        print(f"{name}: {' '.join(f'{r:.5f}' for r in out[name])} "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
    print(json.dumps({"card": smi, "layers": LAYERS, "batch": B,
                      "prompt": S, "steps": GEN, "rel_by_step": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
