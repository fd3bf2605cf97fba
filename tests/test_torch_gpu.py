"""Tests of the port that need a CUDA card (marker ``gpu``; they skip
without one). This file imports no JAX, so it also runs where only
PyTorch and the CUDA toolkit are installed:

    python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
import os
import tempfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import deterministic, tree
from repro_torch.configs import get_config, get_smoke
from repro_torch.core.perfmodel import StorageRatios
from repro_torch.data import SyntheticLM
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import fused_adam as fad
from repro_torch.kernels import selective_scan as k3
from repro_torch.models import model as mdl
from repro_torch.core.plan import PlanCosts, plan_traffic
from repro_torch.offload import (AutotuneConfig, AutotuneController,
                                 DataParallelOffloadEngine, OffloadConfig,
                                 OffloadEngine)
from repro_torch.serve import ServeConfig, ServeEngine
from repro_torch.core import ScheduleConfig
from repro_torch.optim import AdamConfig
from repro_torch.train import Trainer, checkpoint


def _lens(S):
    """(Sq, Skv) of a case's ``S``."""
    return S if isinstance(S, tuple) else (S, S)


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with -m gpu where there is one)")
    torch.backends.cuda.matmul.allow_tf32 = False


def _k1_cases(with_q0):
    """Ragged GQA cases (S = 200, 8/2 heads, hd 128) in both dtypes, then
    the shapes of chip_smoke.py's K1 gates (``K1_SHAPES``, or
    ``K1B_SHAPES`` without q0): GPT-65B and qwen3-4b widths, the bf16
    kernels' edges (GQA, window and q0 at hd 64, ragged S = 1000), hd 32
    in both dtypes, and the attention architectures' shapes: gemma3-1b at
    hd 256 (global, and windowed with S no whole number of windows), f32
    at hd 256, deepseek-v2-lite's MLA at q/k 192 with v 128 (``hd`` is
    then the pair), its smoke config's (48, 32) in both dtypes, the GQA
    groups of starcoder2 (9), qwen3-moe (16) and phi3 (4), and the
    encoder-decoder and VLM shapes: whisper-base's encoder over 1500 frames
    and its cross-attention of 448 decoder tokens (or 1, in decode: the
    forward only) against them (``S`` is then (Sq, Skv)), in bf16 and in
    f32 (its bf16 training computes the encoder in f32), its decoder's
    causal 448, whisper-base-smoke's cross-attention (16 against 32) in
    f32, internvl2's 64:8 group at hd 128, and jamba-v0.1-52b's attention
    layer in its 2 x 1024 prefill (32:8 at hd 128)."""
    masks = [(True, None, 0), (False, None, 0),
             (True, 40, 5) if with_q0 else (True, 48, 0)]
    cases = [pytest.param(2, 8, 2, 200, 128, dt, c, w, q0,
                          id=f"{dt}-ragged-{'causal' if c else 'full'}"
                             f"{'' if w is None else f'-w{w}'}")
             for dt in ("float32", "bfloat16") for (c, w, q0) in masks]
    card = [
        ("gpt-65b-2048", 1, 64, 64, 2048, 128, "bfloat16", True, None, 0),
        ("gpt-65b-1024", 1, 64, 64, 1024, 128, "bfloat16", True, None, 0),
        ("gpt-65b-512", 1, 64, 64, 512, 128, "bfloat16", True, None, 0),
        ("qwen3-4b-gqa-1024", 1, 32, 8, 1024, 128, "bfloat16", True, None,
         0),
        ("f32-full", 2, 4, 4, 256, 64, "float32", False, None, 0),
        ("f32-gqa-window-q0", 1, 8, 2, 200, 64, "float32", True, 48, 16),
        ("bf16-gqa-hd64-ragged-window-q0", 1, 8, 2, 200, 64, "bfloat16",
         True, 48, 16),
        ("bf16-ragged-1000", 1, 16, 16, 1000, 128, "bfloat16", True, None,
         0),
        ("qwen3-4b-smoke-f32-hd32", 2, 4, 4, 64, 32, "float32", True, None,
         0),
        ("bf16-gqa-hd32-ragged-window-q0", 1, 8, 2, 200, 32, "bfloat16",
         True, 48, 16),
        ("f32-gqa-hd32-ragged-window-q0", 1, 8, 2, 200, 32, "float32", True,
         48, 16),
        ("bf16-hd32-2048", 1, 16, 16, 2048, 32, "bfloat16", True, None, 0),
        ("gpt-100m-train-256", 16, 12, 12, 256, 64, "bfloat16", True, None,
         0),
        ("gemma3-1b-global-2048", 1, 4, 1, 2048, 256, "bfloat16", True,
         None, 0),
        ("gemma3-1b-local-1000-w512", 1, 4, 1, 1000, 256, "bfloat16", True,
         512, 0),
        ("f32-hd256-gqa-ragged-window-q0", 1, 4, 1, 200, 256, "float32",
         True, 48, 16),
        ("deepseek-mla-2048", 1, 16, 16, 2048, (192, 128), "bfloat16", True,
         None, 0),
        ("deepseek-mla-1000", 1, 16, 16, 1000, (192, 128), "bfloat16", True,
         None, 0),
        ("f32-mla-ragged-window-q0", 1, 4, 4, 200, (192, 128), "float32",
         True, 48, 16),
        ("deepseek-smoke-mla-f32-48-32", 2, 4, 4, 64, (48, 32), "float32",
         True, None, 0),
        ("deepseek-smoke-mla-bf16-48-32", 2, 4, 4, 64, (48, 32), "bfloat16",
         True, None, 0),
        ("starcoder2-g9-2048", 1, 36, 4, 2048, 128, "bfloat16", True, None,
         0),
        ("qwen3-moe-g16-1024", 1, 64, 4, 1024, 128, "bfloat16", True, None,
         0),
        ("phi3-g4-2048", 1, 40, 10, 2048, 128, "bfloat16", True, None, 0),
        ("whisper-encoder-1500", 4, 8, 8, 1500, 64, "bfloat16", False, None,
         0),
        ("whisper-encoder-f32-1500", 4, 8, 8, 1500, 64, "float32", False,
         None, 0),
        ("whisper-decoder-448", 4, 8, 8, 448, 64, "bfloat16", True, None, 0),
        ("whisper-cross-448x1500", 4, 8, 8, (448, 1500), 64, "bfloat16",
         False, None, 0),
        ("whisper-cross-f32-448x1500", 4, 8, 8, (448, 1500), 64, "float32",
         False, None, 0),
        ("whisper-decode-cross-1x1500", 2, 8, 8, (1, 1500), 64, "bfloat16",
         False, None, 0),
        ("whisper-smoke-cross-f32-16x32", 2, 4, 4, (16, 32), 32, "float32",
         False, None, 0),
        ("internvl2-g8-1024", 1, 64, 8, 1024, 128, "bfloat16", True, None, 0),
        ("jamba-g4-2x1024", 2, 32, 8, 1024, 128, "bfloat16", True, None, 0),
    ]
    if not with_q0:   # the backward's table: no q0, no decode, and two
        # GPT-65B rows
        card = [(c[0].replace("-q0", ""),) + c[1:-1] + (0,) for c in card
                if c[0] not in ("gpt-65b-1024", "gpt-65b-512")
                and "decode" not in c[0]]
    return cases + [pytest.param(*c[1:], id=c[0]) for c in card]


@pytest.mark.gpu
@pytest.mark.parametrize("B,Hq,Hk,S,hd,dtype,causal,window,q0",
                         _k1_cases(with_q0=True))
def test_hopper_kernel_matches_plain(B, Hq, Hk, S, hd, dtype, causal, window,
                                     q0):
    """K1 on the card against its plain version at the card gates' shapes:
    bf16 2e-2 (atol and rtol) and 1e-2 relative norm, f32 1e-5, lse
    1e-3; one launch counted per call."""
    _need_card()
    dt = getattr(torch, dtype)
    hd, hv = hd if isinstance(hd, tuple) else (hd, hd)
    sq, skv = _lens(S)
    g = torch.Generator(device="cuda").manual_seed(0)
    q = torch.randn(B, Hq, sq, hd, device="cuda", generator=g).to(dt)
    k = torch.randn(B, Hk, skv, hd, device="cuda", generator=g).to(dt)
    v = torch.randn(B, Hk, skv, hv, device="cuda", generator=g).to(dt)
    tol = 2e-2 if dtype == "bfloat16" else 1e-5
    kw = dict(causal=causal, window=window, q0=q0)
    before = fa.fwd_launches
    out, lse = fa.flash_attention_fwd(q, k, v, **kw)
    torch.cuda.synchronize()
    assert fa.fwd_launches == before + 1
    ref, ref_lse = fa.flash_attention_plain(q, k, v, **kw,
                                            **fa.plain_chunks(*_lens(S)))
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)
    rel = (out.float() - ref.float()).norm() / ref.float().norm()
    assert float(rel) <= 1e-2
    torch.testing.assert_close(lse, ref_lse, atol=1e-3, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("hd,hv,dtype", [(80, 80, "bfloat16"),
                                         (80, 80, "float32")])
def test_kernel_refuses_head_dims_not_instantiated(hd, hv, dtype):
    """Head dims no config has (80) raise instead of launching or falling
    back to the plain version."""
    _need_card()
    dt = getattr(torch, dtype)
    q = torch.zeros(1, 2, 64, hd, device="cuda", dtype=dt)
    v = torch.zeros(1, 2, 64, hv, device="cuda", dtype=dt)
    before = fa.fwd_launches
    with pytest.raises(ValueError, match="head dims"):
        fa.flash_attention_fwd(q, q, v)
    assert fa.fwd_launches == before


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["phi3-medium-14b", "starcoder2-7b",
                                  "gemma3-1b", "deepseek-v2-lite-16b",
                                  "qwen3-moe-235b-a22b", "whisper-base",
                                  "internvl2-76b"])
def test_smoke_archs_on_the_card_match_the_cpu(arch):
    """chip_smoke.py's gate (w) for one SMOKE config in f32: the card (K1's
    kernels) against the same params on the CPU (their plain versions),
    the loss, each gradient leaf (of its largest element), prefill and 4
    decode steps' logits within 1e-5."""
    _need_card()
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(os.path.dirname(__file__), os.pardir,
                                   "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    assert smoke.ARCHS_SMOKE_TOL == 1e-5
    failures, gaps = smoke.archs_smoke_parity(torch, print, archs=(arch,))
    assert not failures, failures
    assert set(gaps) == {arch}


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "falcon-mamba-7b"])
def test_mamba_smoke_archs_on_the_card_match_the_cpu(arch):
    """chip_smoke.py's gate (w) for a SMOKE config with Mamba layers, f32:
    the training step (the model's chunked scan under autograd on both
    devices; Jamba's attention layer through K1's kernels both ways) within
    1e-5 in the loss and each gradient leaf (of its largest element), the
    prefill (K3 on the card) and 4 decode steps, each from the CPU's
    caches, within 1e-4."""
    _need_card()
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(os.path.dirname(__file__), os.pardir,
                                   "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    assert smoke.ARCHS_SMOKE_TOL == 1e-5 and smoke.MAMBA_PARITY_TOL == 1e-4
    failures, gaps = smoke.archs_smoke_parity(torch, print, archs=(arch,))
    assert not failures, failures
    assert gaps[arch]["decode_from_cpu_state"]


@pytest.mark.gpu
def test_mla_smoke_bf16_on_the_card_matches_the_cpu():
    """chip_smoke.py's gate (w) in bf16: deepseek-v2-lite-smoke's training
    step (its MLA through K1's bf16 kernels at q/k 48, v 32, both ways)
    on the card against the CPU, the loss within the MoE stacks' bf16
    tolerance."""
    _need_card()
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(os.path.dirname(__file__), os.pardir,
                                   "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    assert smoke.ARCHS_SMOKE_BF16_RTOL == 2e-3
    failures, gaps = smoke.archs_smoke_bf16(torch, fa, print)
    assert not failures, failures


@pytest.mark.gpu
def test_serve_engine_on_the_card_matches_in_memory_reference():
    """The engine on ``cuda`` (its default device) in f32: logits bitwise
    equal to the in-memory B=1 decode across a preempt, K1 launched once
    per layer per prefill."""
    _need_card()
    cfg = get_config("gpt-tiny")
    params = mdl.init_params(cfg, 0, dtype=torch.float32, device="cuda")
    prompt, gen, max_len = list(range(3, 67)), 4, 72
    with tempfile.TemporaryDirectory() as d:
        eng = ServeEngine(cfg, ServeConfig(max_len=max_len,
                                           record_logits=True), 0, d,
                          params=params)
        rid = eng.submit(prompt, gen)
        before = fa.fwd_launches
        eng.step()
        eng.preempt(rid)
        while eng.pending():
            eng.step()
        assert fa.fwd_launches - before == cfg.num_layers
        got = eng.requests[rid].logits
        eng.close()
    caches = mdl.init_caches(cfg, 1, max_len, torch.float32, device="cuda")
    logits, caches = mdl.prefill(
        params, cfg, {"tokens": torch.tensor([prompt], device="cuda")},
        caches)
    want = [logits.cpu().numpy()]
    for i in range(gen - 1):
        tok = torch.argmax(logits[0]).view(1, 1)
        logits, caches = mdl.decode_step(params, cfg, tok, len(prompt) + i,
                                         caches)
        want.append(logits.cpu().numpy())
    assert len(got) == gen
    for a, b in zip(got, want):
        assert (a == b).all()


@pytest.mark.gpu
@pytest.mark.parametrize("B,Hq,Hk,S,hd,dtype,causal,window,q0",
                         _k1_cases(with_q0=False))
def test_bwd_kernel_matches_plain_and_is_deterministic(B, Hq, Hk, S, hd,
                                                       dtype, causal, window,
                                                       q0):
    """K1's backward on the card against its plain version at the card
    gates' shapes (bf16 2e-2 and 1e-2 relative norm, f32 1e-5), and the
    same bits on a second launch (no float atomics)."""
    _need_card()
    dt = getattr(torch, dtype)
    hd, hv = hd if isinstance(hd, tuple) else (hd, hd)
    sq, skv = _lens(S)
    g = torch.Generator(device="cuda").manual_seed(1)
    q = torch.randn(B, Hq, sq, hd, device="cuda", generator=g).to(dt)
    do = torch.randn(B, Hq, sq, hv, device="cuda", generator=g).to(dt)
    k = torch.randn(B, Hk, skv, hd, device="cuda", generator=g).to(dt)
    v = torch.randn(B, Hk, skv, hv, device="cuda", generator=g).to(dt)
    tol = 2e-2 if dtype == "bfloat16" else 1e-5
    kw = dict(causal=causal, window=window)
    out, lse = fa.flash_attention_fwd(q, k, v, **kw)
    before = fa.bwd_launches
    got = fa.flash_attention_bwd(q, k, v, out, do, lse, **kw)
    again = fa.flash_attention_bwd(q, k, v, out, do, lse, **kw)
    torch.cuda.synchronize()
    assert fa.bwd_launches == before + 2
    want = fa.flash_attention_bwd_plain(q, k, v, out, do, lse, **kw,
                                        **fa.plain_chunks(*_lens(S)))
    for a, b, w in zip(got, again, want):
        assert torch.equal(a, b)
        torch.testing.assert_close(a.float(), w.float(), atol=tol, rtol=tol)
        rel = (a.float() - w.float()).norm() / w.float().norm()
        assert float(rel) <= 1e-2


@pytest.mark.gpu
@pytest.mark.parametrize("pdtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("step", [1, 10])
def test_fused_adam_kernel_matches_plain(pdtype, step):
    """K2 on the card against its plain version (tests/test_kernels.py's
    tolerances), and the two-stage [0,k) + [k,n) launch bitwise equal to
    one full launch."""
    _need_card()
    n = 4097
    g = torch.Generator(device="cuda").manual_seed(2)
    p = torch.randn(n, device="cuda", generator=g).to(getattr(torch, pdtype))
    m = torch.randn(n, device="cuda", generator=g) * 0.1
    v = torch.randn(n, device="cuda", generator=g).abs() * 0.01
    gr = torch.randn(n, device="cuda", generator=g)
    before = fad.launches
    got = fad.fused_adam(p, m, v, gr, step, lr=1e-2)
    torch.cuda.synchronize()
    assert fad.launches == before + 1
    want = fad.fused_adam_plain(p, m, v, gr, step, lr=1e-2)
    for a, w, tol in zip(got, want, (1e-6, 1e-7, 1e-7, 2e-2)):
        torch.testing.assert_close(a.float(), w.float(), atol=tol,
                                   rtol=1e-7)
    p1, m1, v1, _ = fad.fused_adam(p, m, v, gr, step, lo=0, hi=2500, lr=1e-2)
    two = fad.fused_adam(p1, m1, v1, gr, step, lo=2500, hi=n, lr=1e-2)
    for a, b in zip(got[:3], two[:3]):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_offload_engine_alpha_is_bitwise_on_the_card():
    """gpt-tiny f32 on the card with deterministic algorithms: α = 0 and
    α = 0.25 give the same losses, bit for bit; K1 forward runs twice per
    (layer, micro-batch), its backward and K2's three head updates once
    per step."""
    _need_card()
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    cfg = get_config("gpt-tiny")
    data = SyntheticLM(cfg.vocab_size, seed=0)
    batches = [data.batch(8, 64) for _ in range(3)]
    torch.use_deterministic_algorithms(True)
    try:
        runs = []
        for alpha in (0.0, 0.25):
            with tempfile.TemporaryDirectory() as d:
                eng = OffloadEngine(cfg, OffloadConfig(
                    num_microbatches=4, micro_batch=2, seq_len=64,
                    alpha=alpha, ratios=StorageRatios(0.5, 0.5, 0.5)), 0, d)
                c0 = (fa.fwd_launches, fa.bwd_launches, fad.launches)
                runs.append([eng.train_step(b) for b in batches])
                eng.finish()
                c1 = (fa.fwd_launches, fa.bwd_launches, fad.launches)
                eng.close()
            L, M = cfg.num_layers, 4
            assert [b - a for a, b in zip(c0, c1)] == [2 * L * M * 3,
                                                       L * M * 3, 3 * 3]
    finally:
        torch.use_deterministic_algorithms(False)
    assert runs[0] == runs[1]


@pytest.mark.gpu
def test_offload_engine_spill_is_bitwise_recompute_on_the_card():
    """gpt-tiny f32 on the card with deterministic algorithms: spill and
    recompute give the same losses and final masters, bit for bit; under
    spill K1's forward runs once per (layer, micro-batch) — nothing is
    recomputed — and no micro-batch falls back."""
    _need_card()
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    cfg = get_config("gpt-tiny")
    data = SyntheticLM(cfg.vocab_size, seed=0)
    batches = [data.batch(8, 64) for _ in range(2)]
    L, M = cfg.num_layers, 4
    torch.use_deterministic_algorithms(True)
    try:
        runs = {}
        for policy, fwd in (("recompute", 2), ("spill", 1)):
            with tempfile.TemporaryDirectory() as d:
                eng = OffloadEngine(cfg, OffloadConfig(
                    num_microbatches=M, micro_batch=2, seq_len=64,
                    activation_policy=policy,
                    ratios=StorageRatios(0.5, 0.5, 0.5, act=0.5)), 0, d)
                c0 = fa.fwd_launches
                losses = [eng.train_step(b) for b in batches]
                eng.finish()
                assert fa.fwd_launches - c0 == fwd * L * M * len(batches)
                assert eng.act_fallbacks == 0
                runs[policy] = (losses, torch.cat([
                    torch.from_numpy(v.read()) for v in eng.m_master]))
                eng.close()
    finally:
        torch.use_deterministic_algorithms(False)
    assert runs["spill"][0] == runs["recompute"][0]
    assert torch.equal(runs["spill"][1], runs["recompute"][1])


def _dp_tiny(ranks, d, alpha=0.25, dtype="float32", seed=0):
    ocfg = OffloadConfig(num_microbatches=4, micro_batch=2, seq_len=64,
                         alpha=alpha, param_dtype=dtype,
                         ratios=StorageRatios(0.5, 0.5, 0.5, act=0.5))
    cfg = get_config("gpt-tiny")
    if ranks == 1:
        return OffloadEngine(cfg, ocfg, seed, d)
    return DataParallelOffloadEngine(cfg, ocfg, seed, d, ranks=ranks)


def _dp_state(eng):
    """Final low-precision params and masters, assembled over the ranks."""
    stacks = getattr(eng, "ranks", [eng])
    return [torch.cat([torch.from_numpy(getattr(rk, a)[l].read())
                       for rk in stacks])
            for a in ("p_vecs", "m_master") for l in range(eng.L)]


@pytest.mark.gpu
def test_dp_engine_bytes_launches_and_losses_on_the_card():
    """chip_smoke.py's gate (j) at gpt-tiny width, bf16: 2 simulated
    ranks on the card, 2 steps; every rank's meters equal its
    ``plan_traffic`` x steps, the kernels launch on the path (K1 forward
    2 L M a step, backward L M, K2 3), and the losses are within 1e-4 of
    the single-rank engine's."""
    _need_card()
    cfg = get_config("gpt-tiny")
    data = SyntheticLM(cfg.vocab_size, seed=0)
    batches = [data.batch(8, 64) for _ in range(2)]
    L, M = cfg.num_layers, 4
    runs = {}
    for ranks in (1, 2):
        with tempfile.TemporaryDirectory() as d:
            eng = _dp_tiny(ranks, d, dtype="bfloat16")
            c0 = (fa.fwd_launches, fa.bwd_launches, fad.launches)
            runs[ranks] = [eng.train_step(b) for b in batches]
            eng.finish()
            c1 = (fa.fwd_launches, fa.bwd_launches, fad.launches)
            assert [b - a for a, b in zip(c0, c1)] == [2 * L * M * 2,
                                                       L * M * 2, 3 * 2]
            if ranks > 1:
                pred = plan_traffic(eng.plan, PlanCosts.from_engine(eng))
                assert [dict(rk.meter.bytes) for rk in eng.ranks] == \
                    [{k: 2 * v for k, v in p.items()} for p in pred]
            eng.close()
    for a, b in zip(runs[2], runs[1]):
        assert abs(a - b) <= 1e-4 * abs(b)


@pytest.mark.gpu
def test_dp_engine_is_bitwise_one_rank_on_the_card():
    """chip_smoke.py's gate (k), gpt-tiny f32 with deterministic
    algorithms: 2 ranks == 1 rank (losses, final params and masters) at
    α 0 and 0.25; a data-parallel checkpoint after step 1 resumes
    bitwise in a fresh engine; a mid-run plan swap and an autotuner left
    on leave the trajectory bitwise unchanged."""
    _need_card()
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    cfg = get_config("gpt-tiny")
    data = SyntheticLM(cfg.vocab_size, seed=0)
    batches = [data.batch(8, 64) for _ in range(4)]

    def run(ranks, alpha, hook=None):
        with tempfile.TemporaryDirectory() as d:
            eng = _dp_tiny(ranks, d, alpha)
            after = hook(eng) if hook is not None else None
            losses = []
            for i, b in enumerate(batches):
                losses.append(eng.train_step(b))
                if after is not None:
                    after(i)
            eng.finish()
            assert eng.act_fallbacks == 0
            out = (losses, _dp_state(eng))
            eng.close()
        return out

    def same(a, b):
        return a[0] == b[0] and all(torch.equal(x, y)
                                    for x, y in zip(a[1], b[1]))

    def swap(eng):
        return lambda i: i == 0 and eng.apply_plan_config(
            prefetch_depth=2, activation_policy="spill")

    def tune(eng):
        ctl = AutotuneController(eng, AutotuneConfig(
            interval=2, hysteresis=0.0, cooldown=0,
            prefetch_depths=(0, 1, 2), act_policies=("recompute", "spill")))
        return lambda i: ctl.post_step()

    torch.use_deterministic_algorithms(True)
    try:
        for alpha in (0.0, 0.25):
            ref = run(2, alpha)
            assert same(run(1, alpha), ref), alpha
        assert same(run(2, 0.25, swap), ref)
        assert same(run(2, 0.25, tune), ref)
        with tempfile.TemporaryDirectory() as d1, \
                tempfile.TemporaryDirectory() as d2, \
                tempfile.TemporaryDirectory() as ck:
            a = _dp_tiny(2, d1)
            first = [a.train_step(batches[0])]
            a.save_checkpoint(ck)
            a.close()
            b = _dp_tiny(2, d2, seed=99)
            assert b.restore_checkpoint(ck) == 1
            losses = first + [b.train_step(x) for x in batches[1:]]
            b.finish()
            assert same((losses, _dp_state(b)), ref)
            b.close()
    finally:
        torch.use_deterministic_algorithms(False)


# (B, S, di, st, offset of B in the projection's rows); the first two in
# both dtypes, then chip_smoke.py's K3 edge rows in their dtype
_K3_EDGES = [(3, 77, 1000, 5, 7), (2, 130, 512, 16, 7)]
_K3_CASES = (
    [pytest.param(dt, *c, id=f"{dt}-{'-'.join(map(str, c))}")
     for dt in ("float32", "bfloat16") for c in _K3_EDGES]
    + [pytest.param("bfloat16", 1, 1000, 1000, 13, 7,
                    id="bf16-unaligned-bc-st13"),
       pytest.param("bfloat16", 2, 333, 8192, 16, 256,
                    id="bf16-model-width-S333"),
       pytest.param("float32", 2, 100, 256, 1, 256, id="f32-st1"),
       pytest.param("float32", 1, 77, 301, 3, 7, id="f32-st3-di301"),
       pytest.param("bfloat16", 2, 100, 999, 16, 7, id="bf16-di999"),
       pytest.param("bfloat16", 2, 1024, 8192, 16, 256,
                    id="bf16-jamba-prefill-B2-S1024")])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,B,S,di,st,off", _K3_CASES)
def test_selective_scan_kernel_matches_plain(dtype, B, S, di, st, off):
    """K3 on the card against its plain version: ragged S, di and state,
    K = 1 (st = 1) and one lane a channel (st <= 4), B and C strided
    column slices of one projection (offset 7: not 16-byte aligned;
    offset 256: the model path's), di off the 16-byte copies (999, 301);
    f32 at tests/test_kernels.py's 1e-4, bf16 y at 2e-2; h f32 at 1e-4
    relative; a second launch gives the same bits."""
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(3)
    dt_ = getattr(torch, dtype)
    x = (torch.randn(B, S, di, device="cuda", generator=g) * 0.5).to(dt_)
    proj = torch.randn(B, S, off + 2 * st, device="cuda",
                       generator=g).to(dt_)
    Bc, Cc = proj[..., off:off + st], proj[..., off + st:]
    dt = torch.nn.functional.softplus(
        torch.randn(B, S, di, device="cuda", generator=g) * 0.2)
    A = -torch.exp(torch.randn(di, st, device="cuda", generator=g) * 0.3)
    D = 1.0 + 0.1 * torch.randn(di, device="cuda", generator=g)
    before = k3.launches
    y, h = k3.selective_scan_fwd(x, dt, A, Bc, Cc, D)
    y2, h2 = k3.selective_scan_fwd(x, dt, A, Bc, Cc, D)
    torch.cuda.synchronize()
    assert k3.launches == before + 2
    assert torch.equal(y, y2) and torch.equal(h, h2)
    ry, rh = k3.selective_scan_plain(x, dt, A, Bc, Cc, D)
    tol = 1e-4 if dtype == "float32" else 2e-2
    torch.testing.assert_close(y.float(), ry.float(), atol=tol,
                               rtol=0 if dtype == "float32" else tol)
    assert float((h - rh).abs().max()) <= 1e-4 * float(rh.abs().max())


@pytest.mark.gpu
def test_mamba_prefill_and_decode_on_the_card_match_the_cpu():
    """falcon-mamba-7b smoke in f32: ``prefill`` (K3 in each layer) on the
    card (its default device) against the same params on the CPU, logits
    and h within 1e-4, the bf16 conv tail within 1e-4 plus one bf16 ulp
    (the f32 conv input rounded on each device); then 4 decode steps,
    each started on the card from the CPU's state, at the same limits (a
    tail that rounded the other way would otherwise feed every later
    step)."""
    _need_card()
    cfg = get_smoke("falcon-mamba-7b")
    params = mdl.init_params(cfg, 0, dtype=torch.float32, device="cpu")
    pg = tree.tree_map(lambda a: a.cuda(), params)
    prompt = torch.randint(0, cfg.vocab_size, (2, 40),
                           generator=torch.Generator().manual_seed(0))
    cc = mdl.init_caches(cfg, 2, 44, dtype=torch.float32, device="cpu")
    cg = mdl.init_caches(cfg, 2, 44, dtype=torch.float32)
    before = k3.launches
    lc, cc = mdl.prefill(params, cfg, {"tokens": prompt}, cc)
    lg, cg = mdl.prefill(pg, cfg, {"tokens": prompt.cuda()}, cg)
    assert k3.launches - before == cfg.num_layers
    for i in range(5):
        torch.testing.assert_close(lg.cpu(), lc, atol=1e-4, rtol=0)
        (conv_c, h_c), (conv_g, h_g) = tree.leaves(cc), tree.leaves(cg)
        torch.testing.assert_close(h_g.cpu(), h_c, atol=1e-4, rtol=0)
        torch.testing.assert_close(conv_g.cpu().float(), conv_c.float(),
                                   atol=1e-4, rtol=2 ** -7)
        if i == 4:
            break
        with torch.no_grad():
            for dst, src in zip(tree.leaves(cg), tree.leaves(cc)):
                dst.copy_(src)
        tok = torch.argmax(lc, dim=-1)[:, None]
        lc, cc = mdl.decode_step(params, cfg, tok, 40 + i, cc)
        lg, cg = mdl.decode_step(pg, cfg, tok.cuda(), 40 + i, cg)


def _tiny_trainer(device, base):
    """gpt-tiny, vertical, M 4, alpha 0.25, from a copy of ``base``."""
    return Trainer(get_config("gpt-tiny"),
                   ScheduleConfig(num_microbatches=4, alpha=0.25),
                   AdamConfig(lr=1e-3),
                   params=tree.tree_map(lambda t: t.clone(), base),
                   device=device)


@pytest.mark.gpu
def test_trainer_on_the_card_matches_the_cpu():
    """chip_smoke.py's gate (n): the gpt-tiny ``Trainer`` from f32 params,
    4 steps of 8 x 64 tokens on the card against the same on the CPU
    (the kernels' plain versions): losses within 2e-4 relative, the bf16
    tolerance, because under alpha 0.25 the Trainer runs bf16 params from
    the first step's flush on (measured: 6.5e-5); K1 forward runs twice
    per layer a step (the layer is recomputed for backward), its backward
    once."""
    _need_card()
    base = mdl.init_params(get_config("gpt-tiny"), 1, dtype=torch.float32,
                           device="cpu")
    out = {}
    for dev in ("cuda", "cpu"):
        tr = _tiny_trainer(dev, base)
        c0 = (fa.fwd_launches, fa.bwd_launches)
        losses = tr.run(4, 8, 64, log_every=0).losses
        c1 = (fa.fwd_launches, fa.bwd_launches)
        out[dev] = losses
        if dev == "cuda":
            L = get_config("gpt-tiny").num_layers
            assert [b - a for a, b in zip(c0, c1)] == [2 * L * 4, L * 4]
    np.testing.assert_allclose(out["cuda"], out["cpu"], rtol=2e-4)


@pytest.mark.gpu
def test_trainer_checkpoint_resume_is_bitwise_on_the_card():
    """chip_smoke.py's gate (o): under deterministic algorithms, 4 steps
    of the gpt-tiny ``Trainer`` against 2 steps, ``checkpoint.save``,
    ``restore`` into a fresh Trainer (its data stream advanced past the
    2 batches drawn) and 2 more steps: losses and every param and
    optimizer leaf bitwise."""
    _need_card()
    base = mdl.init_params(get_config("gpt-tiny"), 1, dtype=torch.float32,
                           device="cpu")
    with deterministic(), tempfile.TemporaryDirectory() as d:
        whole = _tiny_trainer("cuda", base)
        lw = whole.run(4, 8, 64, log_every=0).losses
        a = _tiny_trainer("cuda", base)
        la = a.run(2, 8, 64, log_every=0).losses
        checkpoint.save(d, a.params, a.state, step=a.step_num)
        b = _tiny_trainer("cuda", base)
        b.params, b.state, b.step_num = checkpoint.restore(d, a.params,
                                                           a.state)
        for _ in range(b.step_num):
            b.data.batch(8, 64)
        lb = b.run(2, 8, 64, log_every=0).losses
    assert la + lb == lw
    for x, y in zip(tree.leaves((b.params, b.state)),
                    tree.leaves((whole.params, whole.state))):
        assert torch.equal(x, y) if isinstance(y, torch.Tensor) else x == y


# ---------------------------------------------------------------------------
# The mesh: ranks that share the card over gloo (chip_smoke.py's mesh phase
# at SMOKE width)
# ---------------------------------------------------------------------------

def _mesh_smoke_jobs():
    """qwen3-moe-235b-a22b's SMOKE config (4 experts, top-2) on a 2 x 2
    mesh: EP at capacity 8 and 0.5 from seeded params and tokens, and the
    optimized step in f32 on the card and on the CPU from the same
    params."""
    from repro_torch.launch import sharded
    cfg = get_smoke("qwen3-moe-235b-a22b")
    params = tree.tree_map(lambda a: a.numpy(), mdl.init_params(
        cfg, 3, dtype=torch.float32, device="cpu"))
    tokens = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (8, 32)).astype(np.int64)
    step = {"cfg": cfg, "mesh": (2, 2), "mode": "optimized",
            "params": params, "tokens": tokens, "dtype": torch.float32,
            "steps": 1, "grads": True}
    return cfg, sharded, [
        ("ep", {"cfg": cfg, "mesh": (2, 2), "seed": 11, "x_seed": 12,
                "x_shape": (4, 64, cfg.d_model), "dtype": torch.float32,
                "capacities": [8.0, 0.5]}),
        ("step", {**step, "device": "cuda"}),
        ("step", {**step, "device": "cpu"})]


@pytest.mark.gpu
def test_mesh_ep_and_sharded_step_card_vs_cpu():
    """(m1) and (m3) at SMOKE width on 4 gloo ranks sharing the card: EP
    at capacity 8 equals ``moe_apply`` in one process within 1e-5 (f32)
    and drops nothing; at 0.5 each rank's 64 x 2 assignments meet 2 x 32
    owner slots, so at least 4 x 64 drop; one dispatch a rank a capacity;
    the
    optimized sharded step's loss and gradients on the card's ranks within
    1e-5 of the CPU's (each leaf's largest element), collective counts
    equal on both and to their closed form."""
    _need_card()
    from repro_torch.launch.mesh import run_ranks
    from repro_torch.models import moe as moe_lib
    cfg, sharded, jobs = _mesh_smoke_jobs()
    g = torch.Generator(device="cuda")
    g.manual_seed(11)
    mp = moe_lib.moe_init(g, cfg, torch.float32, device="cuda")
    g.manual_seed(12)
    x = torch.randn((4, 64, cfg.d_model), generator=g, device="cuda") * 0.3
    y_ref, aux_ref = moe_lib.moe_apply(mp, x, cfg, capacity_factor=8.0)
    ranks = run_ranks(sharded.run_jobs, 4, backend="gloo", device="cuda:0",
                      timeout=120, args=(jobs,))
    ep = ranks[0][0]
    assert float((ep[8.0]["y"] - y_ref.cpu()).abs().max()) <= 1e-5
    assert abs(ep[8.0]["aux"] - float(aux_ref)) <= 1e-5
    assert ep["dropped"][8.0] == 0 and ep["dropped"][0.5] >= 4 * 64
    assert all(r[0]["dispatches"] == {8.0: 1, 0.5: 1} for r in ranks)
    card, host = ranks[0][1], ranks[0][2]
    assert card["use_ep"] and abs(card["losses"][0]
                                  - host["losses"][0]) <= 1e-5
    for a, b in zip(tree.leaves(card["grads"]), tree.leaves(host["grads"])):
        assert float((a - b).abs().max()) <= 1e-5 * max(
            1.0, float(b.abs().max()))
    for r in ranks:
        for job in (1, 2):
            assert sharded.counts_equal(r[job]["counts"][0],
                                        r[job]["expected_counts"][0])
