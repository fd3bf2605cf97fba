"""Tests of the port that need a CUDA card (marker ``gpu``; they skip
without one). This file imports no JAX, so it also runs where only
PyTorch and the CUDA toolkit are installed:

    python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
import tempfile

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config
from repro_torch.kernels import flash_attention as fa
from repro_torch.models import model as mdl
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
        before = fa.launches
        out, lse = fa.flash_attention_fwd(q, k, v, **kw)
        torch.cuda.synchronize()
        assert fa.launches == before + 1
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
        before = fa.launches
        eng.step()
        eng.preempt(rid)
        while eng.pending():
            eng.step()
        assert fa.launches - before == cfg.num_layers
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
