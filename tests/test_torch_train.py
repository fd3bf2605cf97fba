"""The port's training math on the CPU against the JAX reference: the
host bf16 conversion, the model's loss and gradients, and the
in-memory train steps (the offload engine's oracle). The engine itself
is tested by ``test_torch_engine.py`` (inside the port) and
``test_torch_offload.py`` (against the reference's engine). Inputs are
numpy arrays from a seed, handed to both sides; the reference's Pallas
kernels are not on this path (its training attention is the chunked
jnp VJP)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import ml_dtypes

from repro.configs import get_config as jax_config
from repro.core import ScheduleConfig as JaxSched
from repro.core import make_delayed_train_step as jax_delayed_step
from repro.core import make_train_step as jax_train_step
from repro.models import model as jax_model
from repro.optim import AdamConfig as JaxAdam
from repro.optim import clip_by_global_norm as jax_clip
from repro.optim import global_norm as jax_global_norm
from repro.optim import init_delayed as jax_init_delayed
from repro.optim import init_state as jax_init_state
from repro_torch import tree
from repro_torch.configs import get_config
from repro_torch.core import (ScheduleConfig, grads_fn, init_train_state,
                              make_delayed_train_step, make_train_step)
from repro_torch.data import SyntheticLM
from repro_torch.models import model as mdl
from repro_torch.offload.stores import host_cast
from repro_torch.optim import (AdamConfig, clip_by_global_norm, flush_late,
                               global_norm)
from repro_torch.weights import params_from_jax

CFG = get_config("gpt-tiny")
JCFG = jax_config("gpt-tiny")


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """These shapes gain nothing from torch's intra-op threads, and under
    the parallel test workers every process's thread team contends for
    the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# host bf16
# ---------------------------------------------------------------------------

def test_host_bf16_conversion_matches_ml_dtypes():
    """f32 -> bf16 on the host (``host_cast``, torch's round to nearest
    even) is bitwise ``ml_dtypes``'s — the reference's host conversion —
    on random values, random bit patterns (subnormals included), exact
    ties, ±0, ±inf and the largest finite values. A NaN stays a NaN;
    its sign and payload are not a value, and the two libraries encode
    it differently (torch 0xffff, ml_dtypes sign | 0x7fc0)."""
    rng = np.random.default_rng(0)
    scaled = (rng.standard_normal(20000).astype(np.float32)
              * np.float32(10.0) ** rng.integers(-45, 38, 20000)
              .astype(np.float32))
    bits = rng.integers(0, 2 ** 32, 20000, dtype=np.uint64) \
        .astype(np.uint32).view(np.float32)
    ties = ((np.arange(2000, dtype=np.uint32) << 16) | 0x8000) \
        .view(np.float32)
    special = np.array([0.0, -0.0, np.inf, -np.inf, 1e-40, -1e-40, 1e-45,
                        3.4028235e38, -3.4028235e38, np.nan, -np.nan],
                       np.float32)
    x = np.concatenate([scaled, bits, ties, special])
    got = host_cast(x, torch.bfloat16)
    with np.errstate(invalid="ignore"):
        want = x.astype(ml_dtypes.bfloat16).view(np.uint16)
    assert got.dtype == np.uint16
    nan = np.isnan(x)
    assert nan.sum() > 10
    np.testing.assert_array_equal(got[~nan], want[~nan])
    assert np.isnan(got[nan].view(ml_dtypes.bfloat16)
                    .astype(np.float32)).all()


# ---------------------------------------------------------------------------
# loss and gradients
# ---------------------------------------------------------------------------

def _jax_params(jcfg, seed=0):
    return jax_model.init_params(jcfg, jax.random.PRNGKey(seed),
                                 dtype=jnp.float32)


def _tokens(cfg, B, L, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, L),
                                                dtype=np.int32)


def _port_value_and_grad(params, cfg, tok, remat=True):
    leaves, treedef = tree.flatten(params)
    leaves = [p.detach().requires_grad_() for p in leaves]
    loss = mdl.loss_fn(tree.unflatten(treedef, leaves), cfg,
                       {"tokens": torch.from_numpy(tok).long()}, remat=remat)
    return loss.detach(), torch.autograd.grad(loss, leaves)


@pytest.mark.parametrize("name", ["gpt-tiny", "qwen3-4b"])
def test_loss_and_grads_match_jax(name):
    """``loss_fn`` and its gradients against the reference's in f32 on
    gpt-tiny and on qwen3-4b ``.reduced()`` (GQA, qk-norm, swiglu):
    atol 1e-5 on the loss, 1e-5 + 1e-4 relative on every gradient (f32
    sums in another order)."""
    jcfg, cfg = jax_config(name), get_config(name)
    if name == "qwen3-4b":
        jcfg, cfg = jcfg.reduced(), cfg.reduced()
    jp = _jax_params(jcfg)
    tok = _tokens(cfg, 2, 32)
    jl, jg = jax.value_and_grad(lambda p: jax_model.loss_fn(
        p, jcfg, {"tokens": jnp.asarray(tok)}))(jp)
    params = params_from_jax(jax.tree.map(np.asarray, jp))
    loss, grads = _port_value_and_grad(params, cfg, tok)
    np.testing.assert_allclose(float(loss), float(jl), atol=1e-5)
    for g, w in zip(grads, jax.tree.leaves(jg)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                   rtol=1e-4)


def test_remat_does_not_change_loss_or_grads():
    """Per-layer ``torch.utils.checkpoint`` recomputes the same ops, so
    the loss and every gradient are bitwise the same with and without
    it."""
    params = mdl.init_params(CFG, 1, dtype=torch.float32, device="cpu")
    tok = _tokens(CFG, 2, 32, 1)
    l1, g1 = _port_value_and_grad(params, CFG, tok, remat=True)
    l0, g0 = _port_value_and_grad(params, CFG, tok, remat=False)
    assert torch.equal(l1, l0)
    assert all(torch.equal(a, b) for a, b in zip(g1, g0))


# falcon-mamba-7b smoke (pure Mamba-1, 2 layers): train mode runs the
# model's chunked scan on both sides (K3 has no backward)
SSM = "falcon-mamba-7b"


def test_ssm_loss_and_grads_match_jax():
    """``loss_fn`` and its gradients on the falcon-mamba-7b smoke model
    against the reference's, f32, at the dense models' limits: the loss
    within 1e-5, every gradient (``A_log``, ``D`` and ``dt_bias``
    included) within 1e-5 + 1e-4 relative. Measured: 1.4e-6 on the loss,
    at most 1.1e-7 on a gradient (gradients of order 0.05)."""
    jcfg, cfg = jax_config(SSM).reduced(), get_config(SSM).reduced()
    jp = _jax_params(jcfg, 3)
    tok = _tokens(cfg, 2, 48, 3)
    jl, jg = jax.value_and_grad(lambda p: jax_model.loss_fn(
        p, jcfg, {"tokens": jnp.asarray(tok)}))(jp)
    params = params_from_jax(jax.tree.map(np.asarray, jp))
    loss, grads = _port_value_and_grad(params, cfg, tok)
    np.testing.assert_allclose(float(loss), float(jl), atol=1e-5)
    jleaves = jax.tree.leaves(jg)
    assert len(grads) == len(jleaves) == 13   # embed, 10 block, norm, head
    for g, w in zip(grads, jleaves):
        assert float(np.abs(np.asarray(w)).max()) > 0
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                   rtol=1e-4)


def test_ssm_vertical_equals_horizontal():
    """The paper's identity (§3.4) for SSM blocks inside the port, as
    tests/test_schedules.py holds it for the reference: vertical and
    horizontal (M = 2) gradients of the falcon-mamba-7b smoke model, at
    that test's limits for SSM blocks (loss 1e-4, gradients 5e-4 + 2e-3
    relative)."""
    cfg = get_config(SSM).reduced()
    params = params_from_jax(jax.tree.map(np.asarray,
                                          _jax_params(jax_config(SSM)
                                                      .reduced(), 1)))
    batch = {"tokens": torch.from_numpy(_tokens(cfg, 4, 32, 5)).long()}
    lv, gv = grads_fn(cfg, ScheduleConfig("vertical"))(params, batch)
    lh, gh = grads_fn(cfg, ScheduleConfig("horizontal",
                                          num_microbatches=2))(params, batch)
    assert abs(float(lv) - float(lh)) < 1e-4
    for a, b in zip(tree.leaves(gv), tree.leaves(gh)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=5e-4,
                                   rtol=2e-3)


def test_ssm_remat_does_not_change_loss_or_grads():
    """Per-layer checkpoints around the scan's own per-chunk checkpoints
    recompute the same ops: loss and gradients bitwise equal."""
    cfg = get_config(SSM).reduced()
    params = mdl.init_params(cfg, 2, dtype=torch.float32, device="cpu")
    tok = _tokens(cfg, 2, 40, 2)
    l1, g1 = _port_value_and_grad(params, cfg, tok, remat=True)
    l0, g0 = _port_value_and_grad(params, cfg, tok, remat=False)
    assert torch.equal(l1, l0)
    assert all(torch.equal(a, b) for a, b in zip(g1, g0))


@pytest.mark.parametrize("max_norm", [0.05, 1e3])
def test_global_norm_and_clip_match_jax(max_norm):
    """``global_norm`` and ``clip_by_global_norm`` against the
    reference's on one f32 and bf16 tree, with the norm above the limit
    (the grads are scaled) and below it (coefficient 1): norm, coefficient
    and every clipped leaf within 1e-6 relative."""
    rng = np.random.default_rng(4)
    arrs = {"a": rng.standard_normal((8, 16)).astype(np.float32) * 0.01,
            "b": {"c": rng.standard_normal(40).astype(np.float32) * 0.02,
                  "d": rng.standard_normal((3, 5)).astype(np.float32)}}
    jg = jax.tree.map(jnp.asarray, arrs)
    jg["b"]["d"] = jg["b"]["d"].astype(jnp.bfloat16)
    grads = tree.tree_map(torch.from_numpy, arrs)
    grads["b"]["d"] = grads["b"]["d"].to(torch.bfloat16)
    jc, jcoef, jn = jax_clip(jg, max_norm)
    tc, tcoef, tn = clip_by_global_norm(grads, max_norm)
    np.testing.assert_allclose(float(global_norm(grads)),
                               float(jax_global_norm(jg)), rtol=1e-6)
    np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    np.testing.assert_allclose(float(tcoef), float(jcoef), rtol=1e-6)
    assert (float(tcoef) < 1.0) == (max_norm < float(jn))
    for t, w in zip(tree.leaves(tc), jax.tree.leaves(jc)):
        assert t.dtype == torch.float32
        np.testing.assert_allclose(t.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-9)


@pytest.mark.parametrize("kind", ["vertical", "horizontal", "delayed",
                                  "clipped"])
def test_train_steps_match_jax(kind):
    """``make_train_step`` (both schedules) and
    ``make_delayed_train_step`` (α = 0.25), and the vertical step with
    ``clip_norm``, against the reference over 3 steps from the same f32
    params: losses within 1e-4 relative (after step 1 both sides train
    bf16 params cast from f32 masters, so master differences at f32
    rounding can flip a bf16 rounding) and the pre-clip gradient norms
    within 1e-3 relative (from step 2 the vertical schedule's gradients
    are bf16 leaves, each rounded to 8 bits). ``clip_norm`` 2.0 lies
    below every step's gradient norm (~5), so the clipped case scales
    its gradients."""
    delayed = kind == "delayed"
    sched = dict(schedule="horizontal" if kind == "horizontal"
                 else "vertical", num_microbatches=2,
                 alpha=0.25 if delayed else 0.0,
                 clip_norm=2.0 if kind == "clipped" else None)
    jp = _jax_params(JCFG, 2)
    params = params_from_jax(jax.tree.map(np.asarray, jp))
    data = SyntheticLM(CFG.vocab_size, seed=3)
    batches = [data.batch(4, 32) for _ in range(3)]
    jl, tl, jn, tn = [], [], [], []
    if delayed:
        jstep = jax.jit(jax_delayed_step(JCFG, JaxSched(**sched), JaxAdam()))
        jstate = jax_init_delayed(jax_init_state(jp), jp)
        step = make_delayed_train_step(CFG, ScheduleConfig(**sched),
                                       AdamConfig())
        _, state = init_train_state(CFG, params=params, delayed=True)
        for b in batches:
            _, jstate, jm = jstep(jstate, {"tokens": jnp.asarray(b)})
            _, state, m = step(state, {"tokens": torch.from_numpy(b)})
            jl.append(float(jm["loss"]))
            tl.append(float(m["loss"]))
            jn.append(float(jm["grad_norm"]))
            tn.append(float(m["grad_norm"]))
    else:
        jstep = jax.jit(jax_train_step(JCFG, JaxSched(**sched), JaxAdam()))
        jopt = jax_init_state(jp)
        step = make_train_step(CFG, ScheduleConfig(**sched), AdamConfig())
        _, opt = init_train_state(CFG, params=params)
        for b in batches:
            jp, jopt, jm = jstep(jp, jopt, {"tokens": jnp.asarray(b)})
            params, opt, m = step(params, opt, {"tokens": torch.from_numpy(b)})
            jl.append(float(jm["loss"]))
            tl.append(float(m["loss"]))
            jn.append(float(jm["grad_norm"]))
            tn.append(float(m["grad_norm"]))
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    np.testing.assert_allclose(tn, jn, rtol=1e-3)
    if sched["clip_norm"] is not None:
        assert min(tn) > sched["clip_norm"]
    assert tl[2] != tl[0]


def test_delayed_adam_composes_to_one_step_bitwise():
    """The α split is one Adam step split in time: two delayed steps and
    a final flush leave the f32 masters, m and v bitwise equal to two
    standard steps from the same params and batches (every leaf bf16, so
    the delayed step's first cast of the masters gives them back
    exactly)."""
    params = tree.tree_map(lambda t: t.to(torch.bfloat16), mdl.init_params(
        CFG, 6, dtype=torch.bfloat16, device="cpu"))
    data = SyntheticLM(CFG.vocab_size, seed=6)
    batches = [{"tokens": torch.from_numpy(data.batch(2, 16))}
               for _ in range(2)]
    sched = ScheduleConfig(alpha=0.25)
    step = make_train_step(CFG, sched, AdamConfig())
    _, opt = init_train_state(CFG, params=params)
    p = params
    for b in batches:
        p, opt, _ = step(p, opt, b)
    dstep = make_delayed_train_step(CFG, sched, AdamConfig())
    _, state = init_train_state(CFG, params=params, delayed=True)
    for b in batches:
        _, state, _ = dstep(state, b)
    _, state = flush_late(state, AdamConfig(), 0.25)
    for a, b in zip(tree.leaves((opt.master, opt.m, opt.v)),
                    tree.leaves((state.adam.master, state.adam.m,
                                 state.adam.v))):
        assert torch.equal(a, b)
