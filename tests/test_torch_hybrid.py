"""The hybrid family of the port — jamba-v0.1-52b: 1 attention layer in
8, the rest Mamba, MoE on every other layer — against the JAX reference
on the CPU, with the reference's weights (``weights.params_from_jax``).

Two sizes: the SMOKE config (2 layers, a Mamba + MLP block then GQA +
MoE, unrolled into the plan's prefix) and a narrow 16-layer stack with
Jamba's own layout (``attn_every`` 8, attention at index 3), whose plan
is one period of 8 mixed blocks stacked twice: Mamba + MoE blocks, and
caches that hold ``MambaState``s and ``KVCache``s in one stacked tree.

Tolerances: 1e-5 in f32 for the loss and gradients (a weight gradient
sums over every token, so each leaf is held at 1e-5 of its largest
element); 1e-4 for prefill and decode, where the port's prefill runs K3's
plain version against the reference's scan (as
``tests/test_torch_mamba.py`` holds falcon-mamba); the CLI's bf16 losses
at the MoE stacks' 2e-3 (``tests/test_torch_archs.py``: a token whose
router probabilities tie within bf16 rounding can take another expert in
each framework)."""
import dataclasses
import functools
import tempfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.configs import get_config as jget_config
from repro.configs import get_smoke as jget_smoke
from repro.core.schedules import ScheduleConfig as JaxSched
from repro.data import make_batch as jmake_batch
from repro.models import blocks as jblk
from repro.models import model as jmdl
from repro.optim import AdamConfig as JaxAdam
from repro.train import Trainer as JaxTrainer
from repro_torch import tree
from repro_torch.configs import get_config, get_smoke
from repro_torch.kernels import selective_scan as k3
from repro_torch.launch import train as cli
from repro_torch.models import blocks as blk
from repro_torch.models import mamba
from repro_torch.models import model as mdl
from repro_torch.offload import (DataParallelOffloadEngine, OffloadConfig,
                                 OffloadEngine)
from repro_torch.serve import ServeConfig, ServeEngine
from repro_torch.train import Trainer
from repro_torch.weights import caches_from_jax, params_from_jax

NAME = "jamba-v0.1-52b"
ATOL = 1e-5
SCAN_ATOL = 1e-4
#: the conv tail is the f32 conv input rounded to bf16 on both sides
#: (``models/mamba.py``); where the two f32 values straddle a rounding
#: boundary they land one bf16 ulp apart, as ``tests/test_torch_mamba.py``
#: holds them
BF16_ULP = 2 ** -7
CLI_LOSS_RTOL = 2e-3


def _narrow(cfg):
    """Jamba's layout at SMOKE width over 16 layers: a period of 8 (Mamba,
    Mamba + MoE, Mamba, GQA + MoE, then Mamba and Mamba + MoE twice)
    stacked twice."""
    return dataclasses.replace(cfg, num_layers=16, attn_every=8,
                               attn_offset=3)


SIZES = {"smoke": (lambda: jget_smoke(NAME), lambda: get_smoke(NAME)),
         "narrow16": (lambda: _narrow(jget_smoke(NAME)),
                      lambda: _narrow(get_smoke(NAME)))}


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """These shapes gain nothing from torch's intra-op threads, and under
    the parallel test workers every process's thread team contends for
    the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(size):
    jc, tc = SIZES[size]
    return jc(), tc()


@functools.lru_cache(maxsize=None)
def _jax_params(size):
    return jmdl.init_params(_cfgs(size)[0], jax.random.PRNGKey(0),
                            jnp.float32)


def _params(size):
    return params_from_jax(jax.tree.map(np.asarray, _jax_params(size)))


def _np(t):
    return jax.tree.map(np.asarray, t)


def _assert_leaves_close(got, want, msg=""):
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g, w, atol=ATOL * max(1.0, np.abs(w).max()),
                                   err_msg=msg)


# ---------------------------------------------------------------------------
# plan, layout, weights across
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("layers,shape", [
    (32, (0, 8, 4, 0)), (8, (4, 2, 2, 0)), (2, (2, 0, 0, 0)),
    (None, (2, 0, 0, 0))], ids=["32", "8", "2", "smoke"])
def test_build_plan_matches_reference(layers, shape):
    """Jamba's plan at 32 layers (one 8-layer period x 4), the smoke
    gates' 8 (a prefix of 4, then (Mamba, Mamba + MoE) x 2) and 2, and the
    SMOKE config's: the reference's kinds in the reference's order."""
    if layers is None:
        jcfg, cfg = jget_smoke(NAME), get_smoke(NAME)
    else:
        jcfg, cfg = (dataclasses.replace(c, num_layers=layers) for c in
                     (jget_config(NAME), get_config(NAME)))
    jp, tp = jblk.build_plan(jcfg), blk.build_plan(cfg)
    assert (len(tp.prefix), len(tp.period), tp.n_periods,
            len(tp.suffix)) == shape
    assert [dataclasses.asdict(k) for k in tp.all_kinds()] == \
        [dataclasses.asdict(k) for k in jp.all_kinds()]
    kinds = tp.all_kinds()
    assert all(k.moe == (i % 2 == 1) for i, k in enumerate(kinds))


@pytest.mark.parametrize("size", sorted(SIZES))
def test_init_params_has_the_reference_tree(size):
    """The port's own init: the reference's tree (``norm2`` and the MLP or
    MoE after every Mamba mixer, the stacked period's mixed sub-blocks)
    with its leaf shapes and dtypes (f32 ``A_log`` / ``D`` / ``dt_bias``
    beside bf16 projections)."""
    jcfg, cfg = _cfgs(size)
    got = mdl.init_params(cfg, 0, dtype=torch.bfloat16, device="cpu")
    want = jax.eval_shape(lambda: jmdl.init_params(
        jcfg, jax.random.PRNGKey(0), jnp.bfloat16))
    gl, gt = jax.tree.flatten(jax.tree.map(
        lambda t: (tuple(t.shape), str(t.dtype).replace("torch.", "")), got,
        is_leaf=torch.is_tensor))
    wl, wt = jax.tree.flatten(jax.tree.map(
        lambda a: (tuple(a.shape), str(a.dtype)), want))
    assert gt == wt and gl == wl


@pytest.mark.parametrize("size", sorted(SIZES))
def test_caches_and_weights_cross_leaf_by_leaf(size):
    """``init_caches`` has the reference's tree (KV caches and Mamba states
    side by side, stacked along the period axis), ``cache_units`` and their
    bytes equal the reference's; ``params_from_jax`` and
    ``caches_from_jax`` carry every leaf, the stacked period's included,
    bitwise."""
    jcfg, cfg = _cfgs(size)
    jc = jmdl.init_caches(jcfg, 2, 16, dtype=jnp.bfloat16)
    tc = mdl.init_caches(cfg, 2, 16, dtype=torch.bfloat16, device="cpu")
    assert mdl.cache_units(cfg) == jmdl.cache_units(jcfg)
    assert mdl.cache_unit_nbytes(cfg, tc) == jmdl.cache_unit_nbytes(jcfg, jc)
    assert [p for p, _ in tree.flatten_with_path(tc)] == \
        [p for p, _ in tree.flatten_with_path(caches_from_jax(_np(jc)))]
    if size == "narrow16":
        sub = tc["periods"]
        assert isinstance(sub["sub0"]["ssm"], mamba.MambaState)
        assert sub["sub0"]["ssm"].h.shape == (2, 2, cfg.d_inner,
                                              cfg.ssm_state)
        assert sub["sub3"]["kv"].k.shape == (2, 2, cfg.num_kv_heads, 16,
                                             cfg.head_dim)
    rng = np.random.default_rng(0)
    filled = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(
        a.dtype), _np(jc))
    back = caches_from_jax(filled)
    for a, w in zip(tree.leaves(back), jax.tree.leaves(filled)):
        assert a.shape == w.shape
        np.testing.assert_array_equal(a.float().numpy(),
                                      np.asarray(w, np.float32))
    jp = _np(_jax_params(size))
    for a, w in zip(tree.leaves(_params(size)), jax.tree.leaves(jp)):
        np.testing.assert_array_equal(a.numpy(), w)


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("size", sorted(SIZES))
def test_loss_and_gradients_match_reference(size):
    """``loss_fn`` (cross-entropy + ``AUX_COEF`` x the MoE layers' summed
    load-balance loss, each Mamba layer's scan the model's chunked scan)
    and the gradient of every parameter, f32, 2 x 32 tokens; the aux loss
    alone through ``forward_hidden``."""
    jcfg, cfg = _cfgs(size)
    b = jmake_batch(jcfg, 2, 32, seed=0)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    tb = {k: torch.from_numpy(np.asarray(v)) for k, v in b.items()}
    jl, jg = jax.value_and_grad(lambda q: jmdl.loss_fn(q, jcfg, jb))(
        _jax_params(size))
    _, jaux = jmdl.forward_hidden(_jax_params(size), jcfg, jb)
    p = _params(size)
    for t in tree.leaves(p):
        t.requires_grad_()
    before = k3.launches
    loss = mdl.loss_fn(p, cfg, tb)
    loss.backward()
    assert k3.launches == before
    np.testing.assert_allclose(float(loss.detach()), float(jl), atol=ATOL)
    _assert_leaves_close([t.grad.numpy() for t in tree.leaves(p)],
                         jax.tree.leaves(jg), size)
    with torch.no_grad():
        _, aux = mdl.forward_hidden(_params(size), cfg, tb)
    assert float(jaux) > 0
    np.testing.assert_allclose(float(aux), float(jaux), atol=ATOL)


# ---------------------------------------------------------------------------
# prefill and decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("size,impl", [
    ("smoke", "pallas"), ("smoke", "jnp"), ("narrow16", "jnp")])
def test_prefill_and_decode_match_reference(size, impl):
    """f32 prefill of 2 x 12 tokens (the port through K3's plain version,
    the reference through its Pallas kernel in interpret mode or its
    chunked scan), then 4 teacher-forced decode steps: logits and every
    cache leaf (KV rows, conv tails, h) within 1e-4 of the reference's
    after each (a conv tail also within one bf16 ulp).

    Each decode step runs on the port's own KV rows and h, written in
    place by the step before (into the stacked period's tensors: each
    step's h differs from the one before), but on the reference's conv
    tails: a tail element one bf16 ulp apart (``BF16_ULP``) feeds the
    next three steps, and through Mamba, attention and MoE it moved the
    logits by up to 1.3e-3 over 4 steps run on from the port's own tails
    (narrow16), as ``chip_smoke.py``'s ``mamba_parity`` finds on the
    card."""
    jcfg, cfg = _cfgs(size)
    jp, p = _jax_params(size), _params(size)
    S, gen = 12, 4
    toks = np.random.default_rng(1).integers(0, jcfg.vocab_size,
                                             (2, S + gen), dtype=np.int32)
    jc = jmdl.init_caches(jcfg, 2, S + gen, jnp.float32)
    tc = mdl.init_caches(cfg, 2, S + gen, torch.float32, device="cpu")
    jlog, jc = jmdl.prefill(jp, jcfg, {"tokens": jnp.asarray(toks[:, :S])},
                            jc, scan_impl=impl)
    tlog, tc = mdl.prefill(p, cfg, {"tokens": torch.from_numpy(toks[:, :S])},
                           tc)
    _assert_step_close(tlog, jlog, tc, jc)
    h = _mamba_h(tc)
    for i in range(gen):
        ref = dict(tree.flatten_with_path(caches_from_jax(_np(jc))))
        for path, a in tree.flatten_with_path(tc):
            if path.endswith(".conv"):
                a.copy_(ref[path])
        tok = toks[:, S + i:S + i + 1]
        jlog, jc = jmdl.decode_step(jp, jcfg, jnp.asarray(tok), S + i, jc,
                                    scan_impl=impl)
        tlog, tc = mdl.decode_step(p, cfg, torch.from_numpy(tok), S + i, tc)
        _assert_step_close(tlog, jlog, tc, jc)
        h, before = _mamba_h(tc), h
        assert not torch.equal(h, before)


def _assert_step_close(tlog, jlog, tc, jc):
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog),
                               atol=SCAN_ATOL)
    want = caches_from_jax(_np(jc))
    for a, w in zip(tree.leaves(tc), tree.leaves(want)):
        assert a.shape == w.shape and a.dtype == w.dtype
        rtol = BF16_ULP if a.dtype == torch.bfloat16 else 0.0
        np.testing.assert_allclose(a.float().numpy(), w.float().numpy(),
                                   atol=SCAN_ATOL, rtol=rtol)


def _mamba_h(caches):
    """Every Mamba layer's h, stacked period ones included, as one
    tensor (a copy)."""
    return torch.cat([t.reshape(-1).clone() for path, t in
                      tree.flatten_with_path(caches) if path.endswith(".h")])


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("schedule", ["vertical", "horizontal"])
def test_cli_matches_jax_cli_losses(schedule, monkeypatch, capsys):
    """``launch.train.main --arch jamba-v0.1-52b --smoke --device cpu``
    (in memory, bf16 params, 2 steps of 4 x 32 tokens, M 2) from the
    weights of the JAX CLI's Trainer: per-step losses within
    ``CLI_LOSS_RTOL`` of what the JAX CLI's Trainer reports."""
    argv = ["--arch", NAME, "--smoke", "--steps", "2", "--batch", "4",
            "--seq", "32", "--microbatches", "2", "--schedule", schedule,
            "--device", "cpu"]
    args = cli.parse_args(argv)
    jt = JaxTrainer(jget_smoke(NAME), JaxSched(
        schedule=args.schedule, num_microbatches=args.microbatches,
        alpha=args.alpha), JaxAdam(lr=args.lr))
    start = params_from_jax(jax.tree.map(np.asarray, jt.params))
    jl = jt.run(args.steps, args.batch, args.seq, log_every=0).losses
    monkeypatch.setattr(cli, "Trainer",
                        functools.partial(Trainer, params=start))
    out = cli.main(argv)
    assert "final loss" in capsys.readouterr().out
    assert all(np.isfinite(out["losses"]))
    np.testing.assert_allclose(out["losses"], jl, rtol=CLI_LOSS_RTOL)


@pytest.mark.parametrize("engine", ["offload", "dp", "serve"])
def test_engines_refuse_the_hybrid_family(engine):
    """The reference's engines drive dense stacks only
    (``offload/engine.py:412``, ``serve/engine.py:178``): the port's refuse
    Jamba, saying that they follow the reference's."""
    cfg = get_smoke(NAME)
    make = {"offload": lambda d: OffloadEngine(cfg, OffloadConfig(), 0, d,
                                               device="cpu"),
            "dp": lambda d: DataParallelOffloadEngine(
                cfg, OffloadConfig(), 0, d, device="cpu"),
            "serve": lambda d: ServeEngine(cfg, ServeConfig(), 0, d,
                                           device="cpu")}[engine]
    with tempfile.TemporaryDirectory() as d:
        with pytest.raises(NotImplementedError, match="as the reference's"):
            make(d)
