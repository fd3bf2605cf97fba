"""The dropless MoE path on the card (``-m gpu``; skips without one):

    python -m pytest -q -m gpu tests/test_torch_moe_card.py

* the grouped products (``torch._grouped_mm``) against the same
  arithmetic on the CPU at a small size, outputs and gradients, and two
  runs on the card bitwise equal;
* a training step of a MoE stack through the offload engine with CUDA's
  sync debug mode set to raise inside every layer call: the MoE path
  waits for the card nowhere, and the step's host syncs are M + 1;
* the kernels ``torch._grouped_mm`` launches carry the names that
  ``perfbench/metrics/moe_expert_roofline_pct.py`` reads."""
import importlib.util
import os
import tempfile

import numpy as np
import pytest
import torch

from repro_torch.configs.base import ArchConfig, YarnScaling
from repro_torch.models import moe as moe_lib
from repro_torch.offload import OffloadConfig, OffloadEngine

gpu = pytest.mark.gpu

CFG = ArchConfig(name="moe-card", family="moe", source="test", num_layers=3,
                 d_model=128, num_heads=4, num_kv_heads=4, head_dim=32,
                 d_ff=256, vocab_size=512, use_mla=True, kv_lora_rank=64,
                 qk_nope_head_dim=32, qk_rope_head_dim=16, v_head_dim=32,
                 num_experts=16, num_shared_experts=2, moe_top_k=4,
                 moe_d_ff=64, first_dense_layers=1,
                 rope_scaling=YarnScaling(40, 64, 32, 1, 0.707, 0.707),
                 moe_norm_topk=False, moe_aux="seq", moe_aux_alpha=0.001,
                 experts_held=(4, 4))


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with -m gpu where there is one)")
    return torch.device("cuda")


def _params(dev):
    g = torch.Generator(device="cpu").manual_seed(0)
    p = moe_lib.moe_init(g, CFG, torch.bfloat16, device="cpu")
    p["router"] = p["router"].bfloat16()
    return {k: (v.to(dev) if torch.is_tensor(v)
                else {kk: vv.to(dev) for kk, vv in v.items()})
            for k, v in p.items()}


def _run(dev, x):
    p = _params(dev)
    leaves = [p["router"], p["w_gate"], p["w_up"], p["w_down"]]
    for t in leaves:
        t.requires_grad_()
    xx = x.to(dev).requires_grad_()
    y, aux = moe_lib.moe_dropless(p, xx, CFG)
    dy = torch.linspace(-1, 1, y.numel(), device=dev).view_as(y).to(y.dtype)
    grads = torch.autograd.grad((y, aux), [xx] + leaves,
                                (dy, torch.ones_like(aux)))
    return [t.detach().float().cpu() for t in (y, aux, *grads)]


@gpu
def test_grouped_path_on_the_card_matches_the_cpu():
    dev = _card()
    x = torch.randn(2, 128, 128, generator=torch.Generator().manual_seed(1)
                    ).bfloat16()
    card, again, cpu = _run(dev, x), _run(dev, x), _run("cpu", x)
    for a, b in zip(card, again):
        assert torch.equal(a, b)
    for a, b in zip(card, cpu):
        # bf16 products accumulated in another order: a few bf16 ulps
        assert float((a - b).norm() / b.norm()) < 2e-2


@gpu
def test_a_moe_step_waits_for_the_card_only_at_its_syncs():
    dev = _card()
    M = 3
    ocfg = OffloadConfig(num_microbatches=M, micro_batch=2, seq_len=64,
                         alpha=0.25, param_dtype="bfloat16")
    tokens = np.random.default_rng(0).integers(0, CFG.vocab_size, (2 * M, 64))
    with tempfile.TemporaryDirectory() as d:
        eng = OffloadEngine(CFG, ocfg, 0, d, device=dev)
        try:
            eng.train_step(tokens)           # builds and warms every kernel
            eng.finish()
            eng.reset_stats()

            def strict(fn):
                def call(*a, **k):
                    torch.cuda.set_sync_debug_mode("error")
                    try:
                        return fn(*a, **k)
                    finally:
                        torch.cuda.set_sync_debug_mode("default")
                return call
            for name in ("j_layer_fwd", "j_layer_fwd_res", "j_layer_bwd_res"):
                setattr(eng, name, strict(getattr(eng, name)))
            eng.train_step(tokens)
            eng.finish()
            assert eng.host_syncs == M + 1
            c = eng.metrics_snapshot()["counters"]
            assert c["moe_dropped"] == 0
            assert c["moe_assignments"] == 2 * M * 2 * 64 * 4
        finally:
            eng.close()


@gpu
def test_the_grouped_kernels_carry_the_readers_names():
    dev = _card()
    path = os.path.join(os.path.dirname(__file__), "..", "perfbench",
                        "metrics", "moe_expert_roofline_pct.py")
    spec = importlib.util.spec_from_file_location("moe_roofline", path)
    reader = importlib.util.module_from_spec(spec)
    import sys
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..",
                                    "perfbench"))
    spec.loader.exec_module(reader)
    x = torch.randn(2, 128, 128).bfloat16()
    _run(dev, x)
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _run(dev, x)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    for pattern in reader.KERNELS:
        assert any(pattern in n for n in names), (pattern, sorted(set(names)))
