"""Tests of the port that need a CUDA card (marker ``gpu``; they skip
without one). This file imports no JAX, so it also runs where only
PyTorch and the CUDA toolkit are installed:

    python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
import os
import tempfile

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config
from repro_torch.core.perfmodel import StorageRatios
from repro_torch.data import SyntheticLM
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import fused_adam as fad
from repro_torch.models import model as mdl
from repro_torch.offload import OffloadConfig, OffloadEngine
from repro_torch.serve import ServeConfig, ServeEngine


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with -m gpu where there is one)")
    torch.backends.cuda.matmul.allow_tf32 = False


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_hopper_kernel_matches_plain(dtype):
    """K1 on the card against its plain version: GQA, ragged tiles
    (S = 200), causal, non-causal, and window + q0."""
    _need_card()
    dt = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(0)
    q = torch.randn(2, 8, 200, 128, device="cuda", generator=g).to(dt)
    k = torch.randn(2, 2, 200, 128, device="cuda", generator=g).to(dt)
    v = torch.randn(2, 2, 200, 128, device="cuda", generator=g).to(dt)
    tol = 2e-2 if dtype == "bfloat16" else 1e-5
    for kw in (dict(causal=True), dict(causal=False),
               dict(causal=True, window=40, q0=5)):
        before = fa.fwd_launches
        out, lse = fa.flash_attention_fwd(q, k, v, **kw)
        torch.cuda.synchronize()
        assert fa.fwd_launches == before + 1
        ref, ref_lse = fa.flash_attention_plain(q, k, v, **kw)
        torch.testing.assert_close(out.float(), ref.float(), atol=tol,
                                   rtol=tol)
        torch.testing.assert_close(lse, ref_lse, atol=1e-3, rtol=0)


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
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bwd_kernel_matches_plain_and_is_deterministic(dtype):
    """K1's backward on the card against its plain version (GQA 8/2,
    ragged S = 200, causal, non-causal, window), and the same bits on a
    second launch (no float atomics)."""
    _need_card()
    dt = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(1)
    q, do = (torch.randn(2, 8, 200, 128, device="cuda", generator=g).to(dt)
             for _ in range(2))
    k, v = (torch.randn(2, 2, 200, 128, device="cuda", generator=g).to(dt)
            for _ in range(2))
    tol = 2e-2 if dtype == "bfloat16" else 1e-5
    for kw in (dict(causal=True), dict(causal=False),
               dict(causal=True, window=48)):
        out, lse = fa.flash_attention_fwd(q, k, v, **kw)
        before = fa.bwd_launches
        got = fa.flash_attention_bwd(q, k, v, out, do, lse, **kw)
        again = fa.flash_attention_bwd(q, k, v, out, do, lse, **kw)
        torch.cuda.synchronize()
        assert fa.bwd_launches == before + 2
        want = fa.flash_attention_bwd_plain(q, k, v, out, do, lse, **kw)
        for a, b, w in zip(got, again, want):
            assert torch.equal(a, b)
            torch.testing.assert_close(a.float(), w.float(), atol=tol,
                                       rtol=tol)


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
