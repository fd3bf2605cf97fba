"""K1 and K2 in the PyTorch port: the plain versions against the
reference's Pallas kernels (interpret mode) and the model's chunked jnp
attention and its VJP, the autograd function, and the wrappers' dispatch
and input checks. The Hopper kernels themselves are tested on a card by
``test_torch_gpu.py``."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.kernels.flash_attention import flash_attention_fwd as pallas_fwd
from repro.kernels.fused_adam import fused_adam as pallas_adam
from repro.models.attention import flash_attention as jnp_flash
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import fused_adam as fad
from repro_torch.weights import tensor_from_numpy


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """These shapes gain nothing from torch's intra-op threads, and under
    the parallel test workers every process's thread team contends for
    the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(shape_q, shape_kv, dtype, seed):
    """Same values on both sides: numpy from a seed, cast once in JAX,
    the cast bits handed to torch."""
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in (shape_q, shape_kv, shape_kv)]
    jx = [jnp.asarray(a).astype(dtype) for a in arrs]
    tx = [tensor_from_numpy(np.asarray(a)) for a in jx]
    return jx, tx


# the sweep of tests/test_kernels.py::test_flash_attention_sweep
@pytest.mark.parametrize("B,H,S,hd", [
    (1, 1, 128, 64), (2, 4, 256, 64), (1, 2, 512, 128), (2, 1, 384, 128),
])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
def test_plain_matches_pallas_kernel(B, H, S, hd, dtype, causal):
    (q, k, v), (tq, tk, tv) = _inputs((B, H, S, hd), (B, H, S, hd), dtype, 0)
    want = pallas_fwd(q, k, v, causal=causal, block_q=128, block_k=128)
    got, _ = fa.flash_attention_plain(tq, tk, tv, causal=causal)
    assert got.dtype == tq.dtype
    tol = 2e-2 if dtype == jnp.bfloat16 else 1e-5
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("G", [1, 4])
@pytest.mark.parametrize("window", [None, 24])
@pytest.mark.parametrize("q0", [0, 8])
def test_plain_matches_model_attention_gqa_window_q0(G, window, q0):
    """GQA grouping (q head h reads KV head h // G), the sliding window
    and the q0 offset, with several chunks on both axes, in f32."""
    Hk, S, hd = 2, 96, 32
    (q, k, v), (tq, tk, tv) = _inputs((2, Hk * G, S, hd), (2, Hk, S, hd),
                                      jnp.float32, 1)
    want = jnp_flash(q, k, v, causal=True, window=window, q0=q0,
                     q_chunk=32, kv_chunk=16)
    got, lse = fa.flash_attention_plain(tq, tk, tv, causal=True,
                                        window=window, q0=q0, q_chunk=32,
                                        kv_chunk=16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    assert lse.shape == (2, Hk * G, S) and lse.dtype == torch.float32


# the bf16 rows that chip_smoke.py adds to its K1 gates for the redesigned
# kernels, with the head count cut (heads are independent; the GQA ratio
# kept): (Hq, Hk, S, hd, causal, window, q0)
BF16_EDGE_FWD = [
    (4, 1, 200, 64, True, 48, 16),      # GQA 4:1, ragged S, window, q0
    (2, 2, 1000, 128, True, None, 0),   # ragged S = 1000, causal
    (4, 1, 200, 32, True, 48, 16),      # the same edges at hd 32
]


@pytest.mark.parametrize("Hq,Hk,S,hd,causal,window,q0", BF16_EDGE_FWD)
def test_plain_matches_model_attention_bf16_edges(Hq, Hk, S, hd, causal,
                                                  window, q0):
    """At the card gates' bf16 edge shapes, the plain forward (what the
    gates hold the kernel against) matches the model's chunked jnp
    attention: both sum in f32 and round once to bf16, so they part by
    about one bf16 ulp. Held at the gates' bf16 tolerance, 2e-2 (atol and
    rtol) and 1e-2 relative norm."""
    (q, k, v), (tq, tk, tv) = _inputs((1, Hq, S, hd), (1, Hk, S, hd),
                                      jnp.bfloat16, 5)
    want = np.asarray(jnp_flash(q, k, v, causal=causal, window=window,
                                q0=q0), np.float32)
    got, lse = fa.flash_attention_plain(tq, tk, tv, causal=causal,
                                        window=window, q0=q0)
    assert got.dtype == torch.bfloat16 and lse.dtype == torch.float32
    got = got.float().numpy()
    np.testing.assert_allclose(got, want, atol=2e-2, rtol=2e-2)
    assert np.linalg.norm(got - want) <= 1e-2 * np.linalg.norm(want)


def test_plain_gqa_reads_head_over_group():
    """Head h of a GQA call equals an MHA call on KV head h // G — not
    h % Hk."""
    Hk, G, S, hd = 2, 3, 64, 32
    _, (tq, tk, tv) = _inputs((1, Hk * G, S, hd), (1, Hk, S, hd),
                              jnp.float32, 2)
    got, _ = fa.flash_attention_plain(tq, tk, tv)
    for h in range(Hk * G):
        one, _ = fa.flash_attention_plain(
            tq[:, h:h + 1], tk[:, h // G:h // G + 1], tv[:, h // G:h // G + 1])
        np.testing.assert_array_equal(got[:, h:h + 1].numpy(), one.numpy())


def test_plain_lse_is_logsumexp_of_masked_scores():
    S, hd = 48, 32
    _, (tq, tk, tv) = _inputs((1, 2, S, hd), (1, 2, S, hd), jnp.float32, 3)
    _, lse = fa.flash_attention_plain(tq, tk, tv, causal=True, q_chunk=16,
                                      kv_chunk=16)
    s = torch.einsum("bhqd,bhkd->bhqk", tq, tk) / hd ** 0.5
    s = s.masked_fill(torch.ones(S, S, dtype=torch.bool).triu(1), -1e30)
    np.testing.assert_allclose(lse.numpy(), torch.logsumexp(s, -1).numpy(),
                               atol=1e-5)


def test_wrapper_runs_plain_on_cpu_without_launching():
    _, (tq, tk, tv) = _inputs((1, 4, 64, 64), (1, 2, 64, 64), jnp.float32, 4)
    before = fa.fwd_launches
    out, lse = fa.flash_attention_fwd(tq, tk, tv, causal=True)
    ref, ref_lse = fa.flash_attention_plain(tq, tk, tv, causal=True)
    assert fa.fwd_launches == before
    np.testing.assert_array_equal(out.numpy(), ref.numpy())
    np.testing.assert_array_equal(lse.numpy(), ref_lse.numpy())


def test_wrapper_refuses_devices_without_a_path():
    q = torch.empty((1, 2, 64, 64), device="meta")
    with pytest.raises(ValueError, match="device"):
        fa.flash_attention_fwd(q, q, q)


@pytest.mark.parametrize("bad", ["dtype", "head_dim", "layout", "heads"])
def test_kernel_input_checks(bad):
    """What the kernel does not take is refused before any launch."""
    q = torch.zeros((1, 4, 64, 64))
    k = torch.zeros((1, 2, 64, 64))
    v = torch.zeros((1, 2, 64, 64))
    if bad == "dtype":
        q, k, v = q.half(), k.half(), v.half()
    elif bad == "head_dim":
        q, k, v = q[..., :48].contiguous(), k[..., :48].contiguous(), \
            v[..., :48].contiguous()
    elif bad == "layout":
        q = q.transpose(1, 2)
    else:
        k = v = torch.zeros((1, 3, 64, 64))
    with pytest.raises(ValueError):
        fa._check(q, k, v)


# ---------------------------------------------------------------------------
# K1 backward
# ---------------------------------------------------------------------------

# (B, Hk, G, S, hd, causal, window, q_chunk, kv_chunk): causal, non-causal,
# GQA G in {1, 4}, a window, several chunks on both axes, and S = 192 / 200
# not a multiple of the requested chunk (the chunk falls back to a divisor)
BWD_CASES = [
    (1, 2, 1, 64, 32, True, None, 512, 1024),
    (2, 2, 1, 96, 32, False, None, 32, 16),
    (1, 2, 4, 96, 16, True, None, 32, 16),
    (1, 2, 4, 192, 16, True, 48, 128, 128),
    (2, 1, 4, 200, 32, False, 24, 512, 1024),
]


def _bwd_inputs(B, Hk, G, S, hd, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Hk * G, S, hd)).astype(np.float32)
    k, v = (rng.standard_normal((B, Hk, S, hd)).astype(np.float32)
            for _ in range(2))
    do = rng.standard_normal((B, Hk * G, S, hd)).astype(np.float32)
    return q, k, v, do


def _jax_vjp(q, k, v, do, causal, window, q_chunk, kv_chunk):
    out, vjp = jax.vjp(lambda a, b, c: jnp_flash(
        a, b, c, causal=causal, window=window, q_chunk=q_chunk,
        kv_chunk=kv_chunk), q, k, v)
    return [np.asarray(t) for t in (out, *vjp(do))]


@pytest.mark.parametrize("B,Hk,G,S,hd,causal,window,qc,kc", BWD_CASES)
def test_bwd_plain_matches_reference_vjp(B, Hk, G, S, hd, causal, window,
                                         qc, kc):
    """``flash_attention_bwd_plain`` against ``jax.vjp`` of the
    reference's ``flash_attention`` (its ``_flash_vjp_bwd``), f32."""
    q, k, v, do = _bwd_inputs(B, Hk, G, S, hd, 2)
    _, dq, dk, dv = _jax_vjp(q, k, v, do, causal, window, qc, kc)
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    out, lse = fa.flash_attention_plain(tq, tk, tv, causal=causal,
                                        window=window)
    got = fa.flash_attention_bwd_plain(tq, tk, tv, out, tdo, lse,
                                       causal=causal, window=window,
                                       q_chunk=qc, kv_chunk=kc)
    for g, w in zip(got, (dq, dk, dv)):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), w, atol=1e-5)


@pytest.mark.parametrize("B,Hk,G,S,hd,causal,window,qc,kc", BWD_CASES)
def test_autograd_function_matches_reference_vjp(B, Hk, G, S, hd, causal,
                                                 window, qc, kc):
    """Gradients through ``FlashAttention.apply`` (the model's path)
    against the reference's VJP, f32."""
    q, k, v, do = _bwd_inputs(B, Hk, G, S, hd, 3)
    out, dq, dk, dv = _jax_vjp(q, k, v, do, causal, window, qc, kc)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    before = (fa.fwd_launches, fa.bwd_launches)
    o = fa.FlashAttention.apply(tq, tk, tv, causal, window, 0, None)
    o.backward(torch.from_numpy(do))
    assert (fa.fwd_launches, fa.bwd_launches) == before   # CPU: plain
    np.testing.assert_allclose(o.detach().numpy(), out, atol=1e-5)
    for t, w in zip((tq, tk, tv), (dq, dk, dv)):
        np.testing.assert_allclose(t.grad.numpy(), w, atol=1e-5)


# the bf16 rows of chip_smoke.py's K1 backward gates, heads cut as above:
# (Hk, G, S, hd, causal, window)
BF16_EDGE_BWD = [
    (1, 4, 200, 64, True, 48),      # GQA 4:1, ragged S, window
    (2, 1, 1000, 128, True, None),  # ragged S = 1000, causal
    (1, 4, 200, 32, True, 48),      # the same edges at hd 32
]


@pytest.mark.parametrize("Hk,G,S,hd,causal,window", BF16_EDGE_BWD)
def test_bwd_plain_matches_reference_vjp_bf16_edges(Hk, G, S, hd, causal,
                                                    window):
    """At the card gates' bf16 edge shapes, ``flash_attention_bwd_plain``
    (what the gates hold the kernel against) matches ``jax.vjp`` of the
    model's attention in bf16. The reference takes delta from its f32
    ``out``, the port from ``out`` rounded to bf16 (2^-8 relative per
    element), and both round dq, dk, dv once to bf16: held at the gates'
    bf16 tolerance, 2e-2 (atol and rtol) and 1e-2 relative norm."""
    arrs = _bwd_inputs(1, Hk, G, S, hd, 6)
    jq, jk, jv, jdo = (jnp.asarray(a).astype(jnp.bfloat16) for a in arrs)
    tq, tk, tv, tdo = (tensor_from_numpy(np.asarray(a))
                       for a in (jq, jk, jv, jdo))
    _, vjp = jax.vjp(lambda a, b, c: jnp_flash(
        a, b, c, causal=causal, window=window), jq, jk, jv)
    want = [np.asarray(t, np.float32) for t in vjp(jdo)]
    out, lse = fa.flash_attention_plain(tq, tk, tv, causal=causal,
                                        window=window)
    got = fa.flash_attention_bwd_plain(tq, tk, tv, out, tdo, lse,
                                       causal=causal, window=window)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        g = g.float().numpy()
        np.testing.assert_allclose(g, w, atol=2e-2, rtol=2e-2)
        assert np.linalg.norm(g - w) <= 1e-2 * np.linalg.norm(w)


def test_bwd_refuses_a_query_offset_and_foreign_devices():
    q = torch.zeros((1, 2, 64, 64))
    lse = torch.zeros((1, 2, 64))
    for fn in (fa.flash_attention_bwd, fa.flash_attention_bwd_plain):
        with pytest.raises(ValueError, match="q0"):
            fn(q, q, q, q, q, lse, q0=4)
    m = torch.empty((1, 2, 64, 64), device="meta")
    with pytest.raises(ValueError, match="device"):
        fa.flash_attention_bwd(m, m, m, m, m,
                               torch.empty((1, 2, 64), device="meta"))


def test_bwd_wrapper_runs_plain_on_cpu_without_launching():
    q, k, v, do = (torch.from_numpy(a) for a in _bwd_inputs(1, 2, 2, 64, 64,
                                                            4))
    out, lse = fa.flash_attention_fwd(q, k, v)
    before = fa.bwd_launches
    got = fa.flash_attention_bwd(q, k, v, out, do, lse)
    want = fa.flash_attention_bwd_plain(q, k, v, out, do, lse)
    assert fa.bwd_launches == before
    for g, w in zip(got, want):
        assert torch.equal(g, w)


# ---------------------------------------------------------------------------
# K2 fused Adam
# ---------------------------------------------------------------------------

def _adam_inputs(n, seed, zero_state=False):
    rng = np.random.default_rng(seed)
    p = rng.standard_normal(n).astype(np.float32)
    m = (rng.standard_normal(n) * 0.1).astype(np.float32)
    v = (np.abs(rng.standard_normal(n)) * 0.01).astype(np.float32)
    g = rng.standard_normal(n).astype(np.float32)
    if zero_state:
        m, v = np.zeros_like(m), np.zeros_like(v)
    return p, m, v, g


# the sweep of tests/test_kernels.py::test_fused_adam_sweep, same tolerances
@pytest.mark.parametrize("n", [100, 1024, 4097, 65536])
@pytest.mark.parametrize("step", [1, 10])
def test_fused_adam_plain_matches_pallas_kernel(n, step):
    arrs = _adam_inputs(n, 4)
    want = [np.asarray(a, np.float32) for a in
            pallas_adam(*(jnp.asarray(a) for a in arrs), step, lr=1e-2)]
    got = fad.fused_adam_plain(*(torch.from_numpy(a) for a in arrs), step,
                               lr=1e-2)
    assert got[3].dtype == torch.bfloat16
    for g, w, tol in zip(got, want, (1e-6, 1e-7, 1e-7, 2e-2)):
        np.testing.assert_allclose(g.float().numpy(), w, atol=tol)


def test_fused_adam_two_stage_is_bitwise_one_pass():
    """Early [0,k) + late [k,n) == one full pass, bitwise — the α-delayed
    optimizer identity at kernel level (test_kernels.py's
    test_fused_adam_partial_matches_two_stage)."""
    n, k, step = 10_000, 6_000, 5
    p, m, v, g = (torch.from_numpy(a) for a in _adam_inputs(n, 5, True))
    full = fad.fused_adam(p, m, v, g, step, lr=1e-2)
    p1, m1, v1, _ = fad.fused_adam(p, m, v, g, step, lo=0, hi=k, lr=1e-2)
    two = fad.fused_adam(p1, m1, v1, g, step, lo=k, hi=n, lr=1e-2)
    for a, b in zip(full, two):
        assert torch.equal(a, b)
    # outside [lo, hi) every output is the unchanged input
    assert torch.equal(p1[k:], p[k:]) and torch.equal(m1[k:], m[k:])


def test_fused_adam_takes_bf16_params():
    """bf16 ``p`` is read as f32 (the TPU kernel's ``astype``): the same
    result as the f32 pass over the bf16 values."""
    p, m, v, g = (torch.from_numpy(a) for a in _adam_inputs(4097, 6))
    pb = p.to(torch.bfloat16)
    got = fad.fused_adam(pb, m, v, g, 3)
    want = fad.fused_adam(pb.float(), m, v, g, 3)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_fused_adam_wrapper_dispatch():
    p, m, v, g = (torch.from_numpy(a) for a in _adam_inputs(64, 7))
    before = fad.launches
    fad.fused_adam(p, m, v, g, 1)
    assert fad.launches == before
    meta = torch.empty(64, device="meta")
    with pytest.raises(ValueError, match="device"):
        fad.fused_adam(meta, meta, meta, meta, 1)
