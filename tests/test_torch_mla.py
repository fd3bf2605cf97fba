"""The port's MLA (DeepSeek-V2 multi-head latent attention) against the
JAX reference, and K1's plain versions at the head dims MLA gives them
(q/k head dim apart from v's), all in f32 on the CPU with the
reference's weights (``weights.params_from_jax``).

Tolerance 1e-5: single ops of inputs of order 1, summed in another order
by XLA and torch. Gradients of the weights are sums over every token and
reach ~15 in magnitude, so they are held at 1e-5 absolute plus 1e-5
relative (measured: 1.3e-5 absolute at a relative 1.1e-6)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.configs import get_config as jget_config
from repro.models import attention as jattn
from repro.models.attention import flash_attention as jnp_flash
from repro_torch.configs import get_config
from repro_torch.kernels import flash_attention as fa
from repro_torch.models import attention as attn
from repro_torch.weights import caches_from_jax, params_from_jax

ATOL = 1e-5
JCFG = jget_config("deepseek-v2-lite-16b").reduced()
CFG = get_config("deepseek-v2-lite-16b").reduced()


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """These shapes gain nothing from torch's intra-op threads, and under
    the parallel test workers every process's thread team contends for
    the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


# (B, Hq, Hk, S, hd, hdv, causal, window): MLA's full-size pair (192, 128)
# with its scale, deepseek-v2-lite-smoke's (48, 32), GQA, a window and a
# ragged S
MLA_CASES = [
    (1, 2, 2, 64, 192, 128, True, None),
    (2, 4, 4, 40, 48, 32, True, None),
    (1, 4, 2, 72, 48, 32, True, 24),
    (1, 2, 1, 50, 192, 128, False, None),
]


@pytest.mark.parametrize("B,Hq,Hk,S,hd,hdv,causal,window", MLA_CASES)
def test_k1_plain_with_v_head_dim_apart_matches_reference(B, Hq, Hk, S, hd,
                                                          hdv, causal,
                                                          window):
    """K1's plain forward and its VJP (through ``FlashAttention``, the
    model's path) at a v head dim apart from q/k's, against the
    reference's ``flash_attention`` and its ``jax.vjp``, with MLA's
    scale 1/sqrt(hd)."""
    q, do = _rand((B, Hq, S, hd), 1), _rand((B, Hq, S, hdv), 2)
    k, v = _rand((B, Hk, S, hd), 3), _rand((B, Hk, S, hdv), 4)
    sc = 1.0 / np.sqrt(hd)
    out, vjp = jax.vjp(lambda a, b, c: jnp_flash(
        a, b, c, causal=causal, window=window, scale=sc), q, k, v)
    want = [np.asarray(t) for t in (out, *vjp(do))]
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    before = (fa.fwd_launches, fa.bwd_launches)
    o = fa.FlashAttention.apply(tq, tk, tv, causal, window, 0, sc)
    o.backward(torch.from_numpy(do))
    assert (fa.fwd_launches, fa.bwd_launches) == before   # CPU: plain
    assert o.shape == (B, Hq, S, hdv)
    np.testing.assert_allclose(o.detach().numpy(), want[0], atol=ATOL)
    for t, w in zip((tq, tk, tv), want[1:]):
        np.testing.assert_allclose(t.grad.numpy(), w, atol=ATOL)


@pytest.mark.parametrize("hd,hdv,dtype,ok", [
    (192, 128, torch.float32, True), (192, 128, torch.bfloat16, True),
    (48, 32, torch.float32, True), (48, 32, torch.bfloat16, True),
    (128, 64, torch.float32, False), (80, 80, torch.bfloat16, False),
])
def test_kernel_checks_take_only_instantiated_pairs(hd, hdv, dtype, ok):
    """The wrapper's checks (run before any launch) take a v head dim apart
    from q/k's only for the instantiated pairs; head dims no config has
    are refused."""
    q = torch.zeros((1, 4, 64, hd), dtype=dtype)
    k = torch.zeros((1, 2, 64, hd), dtype=dtype)
    v = torch.zeros((1, 2, 64, hdv), dtype=dtype)
    if ok:
        fa._check(q, k, v)
    else:
        with pytest.raises(ValueError, match="head dims"):
            fa._check(q, k, v)


def _mla_params(seed=0):
    jp = jattn.mla_init(jax.random.PRNGKey(seed), JCFG, jnp.float32)
    return jp, params_from_jax(jax.tree.map(np.asarray, jp))


def test_mla_train_output_and_gradients_match_reference():
    """``mla_apply`` in train mode: output and the gradients of every
    parameter and of x, against ``jax.vjp`` of the reference's."""
    jp, p = _mla_params()
    x = _rand((2, 24, JCFG.d_model), 5)
    dy = _rand((2, 24, JCFG.d_model), 6)

    def jf(params, xx):
        return jattn.mla_apply(params, xx, cfg=JCFG, theta=JCFG.rope_theta,
                               mode="train")[0]
    y, vjp = jax.vjp(jf, jp, jnp.asarray(x))
    jgp, jgx = vjp(jnp.asarray(dy))
    for t in p.values():
        t.requires_grad_()
    tx = torch.from_numpy(x).requires_grad_()
    ty, _ = attn.mla_apply(p, tx, cfg=CFG, theta=CFG.rope_theta,
                           mode="train")
    ty.backward(torch.from_numpy(dy))
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(y), atol=ATOL)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), atol=ATOL)
    for name, g in jgp.items():
        np.testing.assert_allclose(p[name].grad.numpy(), np.asarray(g),
                                   atol=ATOL, rtol=ATOL, err_msg=name)


def test_mla_prefill_then_absorbed_decode_match_reference():
    """Prefill fills ``MLACache`` (latent, rope keys, slot positions) as the
    reference does, in place; then three absorbed decode steps: outputs
    and caches equal to the reference's within 1e-5."""
    jp, p = _mla_params(1)
    B, S, L = 2, 12, 16
    x = _rand((B, S + 3, JCFG.d_model), 7)
    jc = jattn.mla_cache_shape(JCFG, B, L, jnp.float32)
    tc = attn.mla_cache_shape(CFG, B, L, torch.float32, device="cpu")
    jy, jc = jattn.mla_apply(jp, jnp.asarray(x[:, :S]), cfg=JCFG,
                             theta=JCFG.rope_theta, cache=jc, mode="prefill")
    ty, tc2 = attn.mla_apply(p, torch.from_numpy(x[:, :S]), cfg=CFG,
                             theta=CFG.rope_theta, cache=tc, mode="prefill")
    assert tc2 is tc and isinstance(tc, attn.MLACache)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=ATOL)
    for i in range(3):
        xs = x[:, S + i:S + i + 1]
        jy, jc = jattn.mla_apply(jp, jnp.asarray(xs), cfg=JCFG,
                                 theta=JCFG.rope_theta, cache=jc, pos=S + i,
                                 mode="decode")
        ty, _ = attn.mla_apply(p, torch.from_numpy(xs), cfg=CFG,
                               theta=CFG.rope_theta, cache=tc, pos=S + i,
                               mode="decode")
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=ATOL)
    want = caches_from_jax(jax.tree.map(np.asarray, jc))
    assert isinstance(want, attn.MLACache)
    for a, b in zip(tc, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=ATOL)
    assert tc.slot_pos.tolist()[:S + 3] == list(range(S + 3))


def test_mla_cache_layout_matches_reference():
    jc = jattn.mla_cache_shape(dataclasses.replace(JCFG), 3, 20, jnp.float32)
    tc = attn.mla_cache_shape(CFG, 3, 20, torch.float32, device="cpu")
    for a, b in zip(jc, tc):
        assert tuple(a.shape) == tuple(b.shape)
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
