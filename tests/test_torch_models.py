"""The port's dense model against the JAX reference, with the reference's
weights converted by ``repro_torch.weights.params_from_jax``.

Everything runs in f32 on the CPU. JAX (XLA) and torch sum in other
orders, so results agree to rounding, not bitwise: single ops within
1e-5 (inputs of order 1, f32 epsilon 1.2e-7 times reductions of a few
hundred terms), whole-model logits within 1e-4 (the same error carried
through embed, every block and the unembedding). Decode is
teacher-forced on the reference's tokens, so one argmax tie between
the frameworks cannot cascade into different continuations."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.configs import get_config as jget_config
from repro.models import attention as jattn
from repro.models import blocks as jblk
from repro.models import common as jcommon
from repro.models import mlp as jmlp
from repro.models import model as jmdl
from repro_torch.configs import get_config
from repro_torch.models import attention as attn
from repro_torch.models import blocks as blk
from repro_torch.models import common
from repro_torch.models import mlp
from repro_torch.models import model as mdl
from repro_torch.weights import params_from_jax, tensor_from_numpy

ATOL_OP = 1e-5
ATOL_LOGITS = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """These shapes gain nothing from torch's intra-op threads, and under
    the parallel test workers every process's thread team contends for
    the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    return tensor_from_numpy(np.asarray(a))


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _qwen_gqa():
    """qwen3-4b reduced (qk-norm, swiglu) with 2 KV heads for 4 q heads."""
    return dataclasses.replace(jget_config("qwen3-4b").reduced(),
                               num_kv_heads=2)


CONFIGS = {
    "gpt-tiny": lambda: jget_config("gpt-tiny"),
    "qwen3-4b-reduced": lambda: jget_config("qwen3-4b").reduced(),
    "qwen3-4b-reduced-gqa": _qwen_gqa,
}


def _port_cfg(jcfg):
    """The port's ArchConfig with the same field values."""
    from repro_torch.configs.base import ArchConfig
    return ArchConfig(**dataclasses.asdict(jcfg))


# ---------------------------------------------------------------------------
# weight conversion
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_params_from_jax_round_trips_bits(dtype):
    cfg = jget_config("gpt-tiny")
    jp = _np_tree(jmdl.init_params(cfg, jax.random.PRNGKey(0), dtype))
    tp = params_from_jax(jp)
    jl, jdef = jax.tree.flatten(jp)
    from repro_torch import tree
    tl = tree.leaves(tp)
    assert len(jl) == len(tl)
    for a, t in zip(jl, tl):
        assert tuple(t.shape) == a.shape
        if a.dtype.name == "bfloat16":
            assert t.dtype == torch.bfloat16
            np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                          a.view(np.int16))
        else:
            assert t.dtype == torch.float32
            np.testing.assert_array_equal(t.numpy(), a)


def test_params_from_jax_maps_stacked_periods_layer_by_layer():
    cfg = jget_config("gpt-tiny")
    jp = _np_tree(jmdl.init_params(cfg, jax.random.PRNGKey(1), jnp.float32))
    tp = params_from_jax(jp)
    for i in range(jblk.build_plan(cfg).n_periods):
        unit = ("period", i, 0)
        jw = jmdl.get_cache_unit(jp, unit)["attn"]["wq"]
        tw = mdl.get_cache_unit(tp, unit)["attn"]["wq"]
        np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))


def test_port_tree_layout_matches_reference():
    """The port's own init has the reference's tree, shapes and dtypes."""
    for name in ("gpt-tiny", "qwen3-4b"):
        jcfg = jget_config(name) if name == "gpt-tiny" else \
            jget_config(name).reduced()
        jp = jax.eval_shape(lambda: jmdl.init_params(
            jcfg, jax.random.PRNGKey(0), jnp.bfloat16))
        tp = mdl.init_params(_port_cfg(jcfg), 0, dtype=torch.bfloat16,
                             device="cpu")
        jl = jax.tree.leaves(jp)
        from repro_torch import tree
        tl = tree.leaves(tp)
        assert [tuple(a.shape) for a in jl] == [tuple(t.shape) for t in tl]
        assert [str(a.dtype) for a in jl] == \
            [str(t.dtype).replace("torch.", "") for t in tl]


def test_init_is_seeded_and_fan_in_scaled():
    cfg = get_config("gpt-tiny")
    a = mdl.init_params(cfg, 3, dtype=torch.float32, device="cpu")
    b = mdl.init_params(cfg, 3, dtype=torch.float32, device="cpu")
    np.testing.assert_array_equal(a["embed"].numpy(), b["embed"].numpy())
    w = a["periods"]["sub0"]["mlp"]["w_out"][0]          # (d_ff, d)
    assert abs(float(w.std()) * cfg.d_ff ** 0.5 - 0.88) < 0.05
    assert float(w.abs().max()) <= 2.0 / cfg.d_ff ** 0.5 + 1e-6


# ---------------------------------------------------------------------------
# single ops
# ---------------------------------------------------------------------------
def test_rms_norm_matches():
    x, s = _rand((2, 5, 64), 0), _rand((64,), 1, 0.1)
    want = jcommon.rms_norm(jnp.asarray(x), jnp.asarray(s), 1e-6)
    got = common.rms_norm(_t(x), _t(s), 1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL_OP)


@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
def test_apply_rope_matches(theta):
    x = _rand((2, 7, 3, 32), 2)
    pos = np.arange(5, 12, dtype=np.int32)[None, :]
    want = jcommon.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    got = common.apply_rope(_t(x), torch.from_numpy(pos), theta)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL_OP)


@pytest.mark.parametrize("act", ["gelu", "swiglu"])
def test_mlp_apply_matches(act):
    jp = _np_tree(jmlp.mlp_init(jax.random.PRNGKey(2), 64, 256, act,
                                jnp.float32))
    x = _rand((2, 5, 64), 3)
    want = jmlp.mlp_apply(jax.tree.map(jnp.asarray, jp), jnp.asarray(x), act)
    got = mlp.mlp_apply(params_from_jax(jp), _t(x), act)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL_OP)


def test_decode_attention_matches():
    q, k, v = _rand((1, 4, 1, 32), 4), _rand((1, 2, 10, 32), 5), \
        _rand((1, 2, 10, 32), 6)
    kv_pos = np.array([0, 1, 2, 3, 4, 5, -2 ** 30, -2 ** 30, -2 ** 30,
                       -2 ** 30], np.int32)
    want = jattn.decode_attention(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), kv_pos=jnp.asarray(kv_pos),
                                  pos=5)
    got = attn.decode_attention(_t(q), _t(k), _t(v),
                                kv_pos=torch.from_numpy(kv_pos), pos=5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL_OP)


# ---------------------------------------------------------------------------
# attention, block, whole model
# ---------------------------------------------------------------------------
def _layer(jcfg, seed):
    kind = jblk.layer_kind(jcfg, 0)
    jp = _np_tree(jblk.block_init(jax.random.PRNGKey(seed), jcfg, kind,
                                  jnp.float32))
    return kind, jp


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_gqa_apply_prefill_and_decode_match(name):
    jcfg = CONFIGS[name]()
    cfg = _port_cfg(jcfg)
    kind, jp = _layer(jcfg, 5)
    S, max_len = 6, 9
    x = _rand((1, S, jcfg.d_model), 6)
    x1 = _rand((1, 1, jcfg.d_model), 7)
    japp = jax.tree.map(jnp.asarray, jp["attn"])
    tp = params_from_jax(jp["attn"])
    jc = jattn.gqa_cache_shape(jcfg, 1, max_len, None, jnp.float32)
    tc = attn.gqa_cache_shape(cfg, 1, max_len, torch.float32, device="cpu")
    jy, jc = jattn.gqa_apply(japp, jnp.asarray(x), cfg=jcfg, window=None,
                             theta=kind.theta, cache=jc, mode="prefill")
    ty, tc = attn.gqa_apply(tp, _t(x), cfg=cfg, window=None,
                            theta=kind.theta, cache=tc, mode="prefill")
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=ATOL_OP)
    for a, b in zip(jc, tc):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=ATOL_OP)
    jy, jc = jattn.gqa_apply(japp, jnp.asarray(x1), cfg=jcfg, window=None,
                             theta=kind.theta, cache=jc, pos=S,
                             mode="decode")
    ty, tc = attn.gqa_apply(tp, _t(x1), cfg=cfg, window=None,
                            theta=kind.theta, cache=tc, pos=S, mode="decode")
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=ATOL_OP)
    np.testing.assert_array_equal(tc.slot_pos.numpy(),
                                  np.asarray(jc.slot_pos))


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_block_apply_prefill_matches(name):
    jcfg = CONFIGS[name]()
    cfg = _port_cfg(jcfg)
    kind, jp = _layer(jcfg, 8)
    x = _rand((2, 8, jcfg.d_model), 9)
    jc = jblk.block_cache_shape(jcfg, kind, 2, 8, jnp.float32)
    tc = blk.block_cache_shape(cfg, blk.layer_kind(cfg, 0), 2, 8,
                               torch.float32, device="cpu")
    jy, _, _ = jblk.block_apply(jax.tree.map(jnp.asarray, jp),
                                jnp.asarray(x), jcfg, kind, mode="prefill",
                                cache=jc)
    ty, _, _ = blk.block_apply(params_from_jax(jp), _t(x), cfg,
                               blk.layer_kind(cfg, 0), mode="prefill",
                               cache=tc)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=ATOL_OP)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_prefill_and_decode_logits_match(name):
    jcfg = CONFIGS[name]()
    cfg = _port_cfg(jcfg)
    jp = jmdl.init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)
    tp = params_from_jax(_np_tree(jp))
    S, gen, max_len = 5, 4, 12
    prompt = np.random.default_rng(10).integers(0, jcfg.vocab_size, (1, S),
                                                dtype=np.int32)
    jc = jmdl.init_caches(jcfg, 1, max_len, dtype=jnp.float32)
    tc = mdl.init_caches(cfg, 1, max_len, dtype=torch.float32, device="cpu")
    jl, jc = jmdl.prefill(jp, jcfg, {"tokens": jnp.asarray(prompt)}, jc)
    tl, tc = mdl.prefill(tp, cfg, {"tokens": torch.from_numpy(prompt)}, tc)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL_LOGITS)
    for i in range(gen):
        tok = int(jnp.argmax(jl[0]))           # teacher-forced on JAX
        jl, jc = jmdl.decode_step(jp, jcfg, jnp.asarray([[tok]], jnp.int32),
                                  jnp.int32(S + i), jc)
        tl, tc = mdl.decode_step(tp, cfg, torch.tensor([[tok]]), S + i, tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   atol=ATOL_LOGITS)


def test_cache_units_and_nbytes_match_reference():
    for name in sorted(CONFIGS):
        jcfg = CONFIGS[name]()
        cfg = _port_cfg(jcfg)
        jt = jmdl.init_caches(jcfg, 1, 16, dtype=jnp.bfloat16)
        tt = mdl.init_caches(cfg, 1, 16, dtype=torch.bfloat16, device="meta")
        assert mdl.cache_units(cfg) == jmdl.cache_units(jcfg)
        assert mdl.cache_unit_nbytes(cfg, tt) == \
            jmdl.cache_unit_nbytes(jcfg, jt)


def test_set_cache_unit_writes_in_place():
    cfg = get_config("gpt-tiny")
    caches = mdl.init_caches(cfg, 1, 8, dtype=torch.float32, device="cpu")
    unit = mdl.cache_units(cfg)[1]
    kv = mdl.get_cache_unit(caches, unit)["kv"]
    ones = {"kv": type(kv)(*(torch.ones_like(t) for t in kv))}
    stacked_k = caches["periods"]["sub0"]["kv"].k
    out = mdl.set_cache_unit(caches, unit, ones)
    assert out is caches
    assert float(stacked_k[1].sum()) == stacked_k[1].numel()
    assert float(stacked_k[0].abs().sum()) == 0.0


@pytest.mark.parametrize("alloc", [
    lambda cfg: mdl.init_params(cfg, 0),
    lambda cfg: mdl.init_caches(cfg, 1, 8),
    lambda cfg: attn.gqa_cache_shape(cfg, 1, 8),
], ids=["init_params", "init_caches", "gqa_cache_shape"])
def test_allocations_default_to_the_card(monkeypatch, alloc):
    """No ``device``: tensors go to ``cuda`` and, without a card, the
    call raises instead of allocating on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        alloc(get_config("gpt-tiny"))


def test_unsupported_layers_raise_naming_the_later_slice():
    windowed = dataclasses.replace(get_config("gpt-tiny"), sliding_window=4,
                                   global_attn_every=2)
    with pytest.raises(NotImplementedError, match="slice"):
        mdl.init_caches(windowed, 1, 8, device="cpu")
