"""The port's MoE layer (``models/moe.py``) and its expert-parallel seam
(``models/moe_ep.py``) against the JAX reference, f32 on the CPU with
the reference's weights.

Routing is ``top_k`` over softmax probabilities of random f32 inputs: a
tie between two experts' probabilities (where ``torch.topk`` and
``lax.top_k`` may pick differently) is unlikely at these sizes, and the
tests would show one as a large mismatch. The combine sums each token's
K expert outputs in the router's order where the reference scatter-adds
them in expert order; with K = 2 (the smoke configs) the two f32 sums
are the same, with K = 3 they differ by rounding only. Tolerance 1e-5;
a weight gradient sums terms over every token, up to ~10 in size for
the router, so each leaf is held at 1e-5 of its largest element
(measured: 1.25e-5 on a router entry of 0.018 in a leaf of max 10)."""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.configs import get_config as jget_config
from repro.models import moe as jmoe
from repro_torch.configs import get_config
from repro_torch.models import moe, moe_ep
from repro_torch.weights import params_from_jax

ATOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """These shapes gain nothing from torch's intra-op threads, and under
    the parallel test workers every process's thread team contends for
    the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(name, **kw):
    return (dataclasses.replace(jget_config(name).reduced(), **kw),
            dataclasses.replace(get_config(name).reduced(), **kw))


# deepseek (swiglu, one shared expert), qwen3-moe (swiglu, none), a gelu
# variant, and 8 experts with top-3
CASES = {
    "deepseek-smoke": lambda: _cfgs("deepseek-v2-lite-16b"),
    "qwen3-moe-smoke": lambda: _cfgs("qwen3-moe-235b-a22b"),
    "gelu-shared": lambda: _cfgs("deepseek-v2-lite-16b", act="gelu"),
    "e8-top3": lambda: _cfgs("qwen3-moe-235b-a22b", num_experts=8,
                             moe_top_k=3),
}


def _params(jcfg, seed=0):
    jp = jmoe.moe_init(jax.random.PRNGKey(seed), jcfg, jnp.float32)
    return jp, params_from_jax(jax.tree.map(np.asarray, jp))


def _x(jcfg, B=2, S=24, seed=1):
    return np.random.default_rng(seed).standard_normal(
        (B, S, jcfg.d_model)).astype(np.float32)


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("capacity_factor", [1.25, 0.5])
def test_moe_apply_matches_reference(case, capacity_factor):
    """Outputs, the aux loss and the gradients of every parameter (the f32
    router included) and of x, at the default capacity factor and at one
    small enough that tokens drop."""
    jcfg, cfg = CASES[case]()
    jp, p = _params(jcfg)
    x = _x(jcfg)
    dy = np.random.default_rng(2).standard_normal(x.shape).astype(
        np.float32)

    def jf(params, xx):
        y, aux = jmoe.moe_apply(params, xx, jcfg,
                                capacity_factor=capacity_factor)
        return y, aux
    (y, aux), vjp = jax.vjp(jf, jp, jnp.asarray(x))
    jgp, jgx = vjp((jnp.asarray(dy), jnp.ones((), jnp.float32)))
    for t in jax.tree.leaves(p):
        t.requires_grad_()
    tx = torch.from_numpy(x).requires_grad_()
    moe.reset_dropped()
    ty, taux = moe.moe_apply(p, tx, cfg, capacity_factor=capacity_factor)
    drops = moe.dropped_count()
    (ty * torch.from_numpy(dy)).sum().add(taux).backward()
    assert p["router"].dtype == torch.float32
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(y), atol=ATOL)
    np.testing.assert_allclose(float(taux.detach()), float(aux), atol=ATOL)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), atol=ATOL)
    flat_j = jax.tree_util.tree_flatten_with_path(jgp)[0]
    for (path, g), t in zip(flat_j, jax.tree.leaves(p)):
        g = np.asarray(g)
        np.testing.assert_allclose(t.grad.numpy(), g,
                                   atol=ATOL * max(1.0, np.abs(g).max()),
                                   err_msg=str(path))
    T, K, E = x.shape[0] * x.shape[1], jcfg.moe_top_k, jcfg.num_experts
    C = int(np.ceil(T * K / E * capacity_factor))
    if capacity_factor < 1:
        assert drops >= T * K - E * C > 0    # more than the buffer holds
    else:
        assert drops >= 0


def test_moe_apply_bf16_runs_and_is_close_to_f32():
    """bf16 experts beside the f32 router: finite output in bf16 within
    bf16 rounding of the f32 layer from the same (rounded) weights."""
    jcfg, cfg = CASES["deepseek-smoke"]()
    _, p = _params(jcfg)
    pb = {k: (v.to(torch.bfloat16) if k != "router" else v)
          if isinstance(v, torch.Tensor) else
          {kk: vv.to(torch.bfloat16) for kk, vv in v.items()}
          for k, v in p.items()}
    pf = {k: (v.float() if isinstance(v, torch.Tensor) else
              {kk: vv.float() for kk, vv in v.items()})
          for k, v in pb.items()}
    x = torch.from_numpy(_x(jcfg))
    yb, auxb = moe.moe_apply(pb, x.to(torch.bfloat16), cfg)
    yf, auxf = moe.moe_apply(pf, x.to(torch.bfloat16).float(), cfg)
    assert yb.dtype == torch.bfloat16 and bool(torch.isfinite(yb).all())
    rel = (yb.float() - yf).norm() / yf.norm()
    assert float(rel) < 2e-2
    assert abs(float(auxb) - float(auxf)) < 1e-2


def test_moe_dispatch_without_a_mesh_is_moe_apply():
    jcfg, cfg = CASES["qwen3-moe-smoke"]()
    _, p = _params(jcfg, 3)
    x = torch.from_numpy(_x(jcfg, seed=4))
    assert not moe_ep.ep_enabled()
    moe_ep.set_ep_mesh(None)            # no mesh: the single-device path
    y1, a1 = moe_ep.moe_dispatch(p, x, cfg)
    y2, a2 = moe.moe_apply(p, x, cfg)
    assert torch.equal(y1, y2) and torch.equal(a1, a2)
    jy, ja = jmoe.moe_apply(jax.tree.map(jnp.asarray, jmoe.moe_init(
        jax.random.PRNGKey(3), jcfg, jnp.float32)), jnp.asarray(x.numpy()),
        jcfg)
    np.testing.assert_allclose(y1.numpy(), np.asarray(jy), atol=ATOL)


def test_moe_apply_is_deterministic():
    """The combine has no atomics: two calls give the same bits (on the
    card as here; the chip smoke's f32 gates rely on it)."""
    jcfg, cfg = CASES["e8-top3"]()
    _, p = _params(jcfg, 5)
    x = torch.from_numpy(_x(jcfg, seed=6))
    y1, a1 = moe.moe_apply(p, x, cfg)
    y2, a2 = moe.moe_apply(p, x, cfg)
    assert torch.equal(y1, y2) and torch.equal(a1, a2)


def _grow(cfg, caches, n):
    """Caches of ``n`` slots holding ``caches``' slots in front."""
    from repro_torch import tree
    from repro_torch.models import model as mdl
    new = mdl.init_caches(cfg, 2, n, torch.float32, device="cpu")
    for old, dst in zip(tree.leaves(caches), tree.leaves(new)):
        ax = [i for i, (a, b) in enumerate(zip(old.shape, dst.shape))
              if a != b]
        (dst.narrow(ax[0], 0, old.shape[ax[0]]) if ax else dst).copy_(old)
    return new


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b",
                                  "qwen3-moe-235b-a22b"])
def test_no_drops_makes_decode_equal_a_fresh_prefill(arch, monkeypatch):
    """The MoE stack in f32: a prefill of 2 x 24 tokens into caches of 24
    slots, then 4 teacher-forced decode steps, each into caches grown by
    one slot (so no step attends an empty slot). With the blocks' MoE at
    ``capacity_factor = E / K`` (C = T, what ``chip_smoke.py``'s MoE
    generation gates substitute for ``moe_ep.moe_dispatch``) no
    assignment drops and the last step's logits equal a fresh prefill's
    over the same 28 tokens within 1e-5; at the reference's capacity the
    two drop different assignments and part by far more."""
    from repro_torch.configs import get_smoke
    from repro_torch.models import model as mdl
    cfg = get_smoke(arch)
    params = mdl.init_params(cfg, 0, dtype=torch.float32, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(7).integers(
        0, cfg.vocab_size, (2, 28)))

    def generate():
        caches = mdl.init_caches(cfg, 2, 24, torch.float32, device="cpu")
        _, caches = mdl.prefill(params, cfg, {"tokens": toks[:, :24]},
                                caches)
        for i in range(4):
            caches = _grow(cfg, caches, 25 + i)
            last, caches = mdl.decode_step(
                params, cfg, toks[:, 24 + i:25 + i], 24 + i, caches)
        fresh = mdl.init_caches(cfg, 2, 28, torch.float32, device="cpu")
        want, _ = mdl.prefill(params, cfg, {"tokens": toks}, fresh)
        return last, want

    with monkeypatch.context() as m:
        m.setattr(moe_ep, "moe_dispatch", functools.partial(
            moe.moe_apply, capacity_factor=cfg.num_experts / cfg.moe_top_k))
        moe.reset_dropped()
        last, want = generate()
        assert moe.dropped_count() == 0
    np.testing.assert_allclose(last.numpy(), want.numpy(), atol=ATOL)
    moe.reset_dropped()
    last, want = generate()
    assert moe.dropped_count() > 0
    assert float((last - want).abs().max()) > 1e-3
