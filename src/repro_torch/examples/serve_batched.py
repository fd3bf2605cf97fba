"""Continuous-batching serving through ``repro_torch.serve.ServeEngine``:
requests stream through admission control, per-step compiled serve
plans (tiered param fetches + KV block spill/fetch at
``IOPriority.KV``), and iteration-level batched decode — with a
preempt-to-SSD / bitwise-resume round trip in the middle.

    python -m repro_torch.examples.serve_batched --arch gpt-tiny
    python -m repro_torch.examples.serve_batched \\
        --arch gpt-tiny --no-offload      # plain in-memory path

``--no-offload`` runs the plain in-memory B=1 loop (the model's
``prefill`` / ``decode_step``) — the bitwise f32 reference: with
``--check`` both paths run and every request's greedy tokens must agree
exactly. The SSM family (falcon-mamba-7b) only supports the
``--no-offload`` path; the families the port does not have yet (VLM,
enc-dec, MoE) are refused by the config registry.
"""
import argparse
import tempfile
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config, get_smoke
from repro_torch.data import SyntheticLM
from repro_torch.models import model as mdl


def reference_decode(cfg, seed, prompts, gen, max_len, device):
    """Plain in-memory decode, one request at a time at B=1 (the bitwise
    f32 reference the offloaded path must match exactly)."""
    params = mdl.init_params(cfg, seed, dtype=torch.float32, device=device)
    outs = []
    for pr in prompts:
        caches = mdl.init_caches(cfg, 1, max_len, dtype=torch.float32,
                                 device=device)
        batch = {"tokens": torch.tensor([pr], dtype=torch.int32,
                                        device=device)}
        logits, caches = mdl.prefill(params, cfg, batch, caches)
        toks = [int(torch.argmax(logits[0]))]
        for i in range(gen - 1):
            logits, caches = mdl.decode_step(
                params, cfg, torch.tensor([[toks[-1]]], dtype=torch.int32,
                                          device=device),
                len(pr) + i, caches)
            toks.append(int(torch.argmax(logits[0])))
        outs.append(toks)
    return outs


def main(argv: Optional[List[str]] = None) -> Dict[str, object]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gpt-tiny")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--gen", type=int, default=8)
    ap.add_argument("--no-offload", action="store_true",
                    help="plain in-memory decode (the bitwise ref)")
    ap.add_argument("--check", action="store_true",
                    help="run BOTH paths; assert token-exact agreement")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    device = resolve_device(args.device)
    max_len = args.prompt_len + args.gen
    seed = 0
    data = SyntheticLM(cfg.vocab_size, seed=0)
    prompts = [list(map(int, row)) for row in
               np.asarray(data.batch(args.batch, args.prompt_len))]

    if args.no_offload or cfg.family != "dense":
        if cfg.family != "dense" and not args.no_offload:
            print(f"{cfg.name}: family {cfg.family!r} serves in-memory "
                  "only (ServeEngine is dense-stack)")
        t0 = time.perf_counter()
        outs = reference_decode(cfg, seed, prompts, args.gen, max_len,
                                device)
        dt = time.perf_counter() - t0
        print(f"{cfg.name}: in-memory decode "
              f"{args.batch * args.gen / dt:.1f} tok/s")
        print("first sequence:", outs[0])
        print("OK")
        return {"tokens": outs, "offloaded": False}

    from repro_torch.serve import ServeConfig, ServeEngine
    with tempfile.TemporaryDirectory(prefix="repro_serve_") as workdir:
        scfg = ServeConfig(max_len=max_len, kv_block_bytes=16 << 10,
                           kv_x_host=0.5, param_x_host=0.5)
        eng = ServeEngine(cfg, scfg, seed, workdir, device=device)
        try:
            rids = [eng.submit(p, args.gen) for p in prompts]
            eng.step()                       # prefill wave
            if args.gen > 2 and len(rids) > 1:
                eng.step()
                eng.preempt(rids[0])         # exercise spill -> resume
            t0 = time.perf_counter()
            while eng.pending():
                eng.step()
            dt = time.perf_counter() - t0
            snap = eng.metrics_snapshot()
            outs = [eng.result(r) for r in rids]
            print(f"{cfg.name}: served {len(rids)} requests, "
                  f"{snap['tokens_decoded']} decode tokens, "
                  f"kv hit-rate {snap['kv']['hit_rate']:.2f}, "
                  f"{snap['tokens_decoded'] / max(dt, 1e-9):.1f} tok/s")
            print("first sequence:", outs[0])
        finally:
            eng.close()

    out = {"tokens": outs, "offloaded": True}
    if args.check:
        ref = reference_decode(cfg, seed, prompts, args.gen, max_len, device)
        out["reference_tokens"] = ref
        if outs != ref:
            raise SystemExit(f"offloaded {outs} != in-memory {ref}")
        print("offloaded == in-memory (token-exact)")
    print("OK")
    return out


if __name__ == "__main__":
    main()
