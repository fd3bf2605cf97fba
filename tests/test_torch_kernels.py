"""K1 in the PyTorch port: the plain version against the reference's
Pallas kernel (interpret mode) and the model's chunked jnp attention,
and the wrapper's dispatch and input checks. The Hopper kernel itself
is tested on a card by ``test_torch_gpu.py``."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro.kernels.flash_attention import flash_attention_fwd as pallas_fwd
from repro.models.attention import flash_attention as jnp_flash
from repro_torch.kernels import flash_attention as fa
from repro_torch.weights import tensor_from_numpy


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
    before = fa.launches
    out, lse = fa.flash_attention_fwd(tq, tk, tv, causal=True)
    ref, ref_lse = fa.flash_attention_plain(tq, tk, tv, causal=True)
    assert fa.launches == before
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
