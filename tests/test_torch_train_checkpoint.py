"""The port's layerwise checkpoints (``repro_torch.train.checkpoint``)
against the reference's ``repro.train.checkpoint`` on the CPU: one file
format. A JAX save restores in the port bitwise and a port save restores
in JAX bitwise, for params and for the plain and α-delayed Adam states,
in bf16 and f32; the npz key sets, the 0-d ``.step`` / ``.has_pending``
arrays and their dtypes are the reference's; and a Trainer resumed from
a checkpoint continues the uninterrupted trajectory bitwise."""
import dataclasses
import os
import tempfile
import zipfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.configs import get_config as jax_config
from repro.core import ScheduleConfig as JaxSched
from repro.optim import AdamConfig as JaxAdam
from repro.optim import init_delayed as jax_init_delayed
from repro.optim import init_state as jax_init_state
from repro.train import Trainer as JaxTrainer
from repro.train import checkpoint as jax_ckpt
from repro_torch import tree
from repro_torch.configs import get_config
from repro_torch.core import ScheduleConfig
from repro_torch.models import model as mdl
from repro_torch.optim import AdamConfig, AdamState, DelayedAdamState
from repro_torch.train import Trainer, checkpoint
from repro_torch.weights import params_from_jax

#: gpt-tiny narrowed (2 layers, d_model 64, 2 heads of 32, d_ff 128,
#: vocab 256): the compressed npz files stay small
SHAPE = dict(num_layers=2, d_model=64, num_heads=2, num_kv_heads=2,
             head_dim=32, d_ff=128, vocab_size=256)
CFG = dataclasses.replace(get_config("gpt-tiny"), **SHAPE)
JCFG = dataclasses.replace(jax_config("gpt-tiny"), **SHAPE)
CASES = [(dt, a) for dt in ("bfloat16", "float32") for a in (0.0, 0.25)]
IDS = [f"{dt}-alpha{a}" for dt, a in CASES]


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _f32(params):
    return jax.tree.map(lambda x: x.astype(jnp.float32), params)


_JAX_TRAINED = {}


def _jax_trained(dtype, alpha):
    """A JAX Trainer after 2 steps of 4 x 32 tokens (nonzero moments, a
    pending α tail). Its updates leave bf16 params; in f32 the params are
    cast to f32 after the run (and were before it). One per (dtype,
    alpha) in this module (each compiles its step); callers read it."""
    if (dtype, alpha) not in _JAX_TRAINED:
        _JAX_TRAINED[dtype, alpha] = _train_jax(dtype, alpha)
    return _JAX_TRAINED[dtype, alpha]


def _train_jax(dtype, alpha):
    jt = JaxTrainer(JCFG, JaxSched(alpha=alpha), JaxAdam(lr=1e-3), seed=0)
    if dtype == "float32":
        jt.params = _f32(jt.params)
        opt = jax_init_state(jt.params)
        jt.state = (jax_init_delayed(opt, jax.tree.map(
            lambda p: jnp.zeros(p.shape, jnp.float32), jt.params))
            if jt.delayed else opt)
    jt.run(2, 4, 32, log_every=0)
    if dtype == "float32":
        jt.params = _f32(jt.params)
    return jt


def _state_from_jax(s):
    """The reference's optimizer state as the port's: the same tree,
    ``AdamState`` / ``DelayedAdamState`` rebuilt as the port's classes,
    the 0-d step and has_pending as Python values."""
    name = type(s).__name__
    if name == "DelayedAdamState":
        return DelayedAdamState(_state_from_jax(s.adam),
                                params_from_jax(jax.tree.map(np.asarray,
                                                             s.pending)),
                                bool(s.has_pending))
    return AdamState(*(params_from_jax(jax.tree.map(np.asarray, t))
                       for t in (s.master, s.m, s.v)), int(s.step))


def _port_trainer(dtype, alpha, jt=None):
    """A port Trainer of the same config, from ``jt``'s params when given,
    else from seeded ``dtype`` params."""
    params = (mdl.init_params(CFG, 0, dtype=getattr(torch, dtype),
                              device="cpu") if jt is None else
              params_from_jax(jax.tree.map(np.asarray, jt.params)))
    return Trainer(CFG, ScheduleConfig(alpha=alpha), AdamConfig(lr=1e-3),
                   params=params, device="cpu")


def _assert_bitwise(got, want):
    gl, wl = tree.leaves(got), tree.leaves(want)
    assert len(gl) == len(wl)
    for a, b in zip(gl, wl):
        if isinstance(b, torch.Tensor):
            assert a.dtype == b.dtype and a.shape == b.shape
            assert torch.equal(a, b)
        else:
            assert type(a) is type(b) and a == b


@pytest.mark.parametrize("dtype,alpha", CASES, ids=IDS)
def test_jax_checkpoint_restores_in_the_port_bitwise(dtype, alpha):
    """``repro.train.checkpoint.save`` of a trained JAX Trainer, restored
    by the port into a port Trainer's tree: params equal
    ``params_from_jax`` of the JAX params, the state the converted JAX
    state, bitwise (bf16 leaves through the f32 npz), and the step."""
    jt = _jax_trained(dtype, alpha)
    tr = _port_trainer(dtype, alpha, jt)
    with tempfile.TemporaryDirectory() as d:
        jax_ckpt.save(d, jt.params, jt.state, step=jt.step_num)
        params, opt, step = checkpoint.restore(d, tr.params, tr.state)
    assert step == 2
    _assert_bitwise(params, params_from_jax(jax.tree.map(np.asarray,
                                                         jt.params)))
    _assert_bitwise(opt, _state_from_jax(jt.state))


@pytest.mark.parametrize("dtype,alpha", CASES, ids=IDS)
def test_port_checkpoint_restores_in_jax_bitwise(dtype, alpha):
    """A port Trainer after 2 steps, saved by the port and restored by
    ``repro.train.checkpoint.restore`` into the JAX Trainer's tree: every
    leaf bitwise the port's tensor, ``.step`` and ``.has_pending`` their
    values."""
    tr = _port_trainer(dtype, alpha)
    tr.run(2, 4, 32, log_every=0)
    if dtype == "float32":
        tr.params = tree.tree_map(lambda t: t.float(), tr.params)
    jt = _jax_trained(dtype, alpha)
    with tempfile.TemporaryDirectory() as d:
        checkpoint.save(d, tr.params, tr.state, step=tr.step_num)
        jp, js, step = jax_ckpt.restore(d, jt.params, jt.state)
    assert step == 2
    _assert_bitwise(params_from_jax(jax.tree.map(np.asarray, jp)),
                    tr.params)
    _assert_bitwise(_state_from_jax(js), tr.state)


@pytest.mark.parametrize("dtype,alpha", CASES, ids=IDS)
def test_npz_keys_and_scalars_are_the_references(dtype, alpha):
    """Both packages write the same npz members (key strings such as
    ``periods/sub0/attn/wq``, ``.master/embed``, ``.adam/.step``,
    ``.pending/...`` and ``.has_pending``), each of the same shape and
    stored dtype: bf16 as f32, ``.step`` a 0-d int32, ``.has_pending`` a
    0-d bool; every member deflated."""
    jt = _jax_trained(dtype, alpha)
    tr = _port_trainer(dtype, alpha, jt)
    tr.state = _state_from_jax(jt.state)
    files = {}
    with tempfile.TemporaryDirectory() as dj, \
            tempfile.TemporaryDirectory() as dt:
        jax_ckpt.save(dj, jt.params, jt.state, step=2)
        checkpoint.save(dt, tr.params, tr.state, step=2)
        for name in ("params.npz", "opt.npz"):
            for side, d in (("jax", dj), ("port", dt)):
                with np.load(os.path.join(d, name)) as z:
                    files[side, name] = {k: (a.shape, a.dtype) for k, a in
                                         ((k, z[k]) for k in z.files)}
                with zipfile.ZipFile(os.path.join(d, name)) as z:
                    assert {i.compress_type for i in z.infolist()} == \
                        {zipfile.ZIP_DEFLATED}
    for name in ("params.npz", "opt.npz"):
        assert files["port", name] == files["jax", name]
    opt = files["port", "opt.npz"]
    step = ".adam/.step" if alpha else ".step"
    assert opt[step] == ((), np.dtype(np.int32))
    if alpha:
        assert opt[".has_pending"] == ((), np.dtype(np.bool_))
        assert any(k.startswith(".pending/") for k in opt)
    assert {dt for _, dt in files["port", "params.npz"].values()} == \
        {np.dtype(np.float32)}
    assert "periods/sub0/attn/wq" in files["port", "params.npz"]


def test_restore_refuses_a_shape_mismatch():
    tr = _port_trainer("float32", 0.0)
    with tempfile.TemporaryDirectory() as d:
        checkpoint.save(d, tr.params, step=0)
        bad = dict(tr.params, embed=torch.zeros(3, 3))
        with pytest.raises(ValueError, match="embed"):
            checkpoint.restore(d, bad)


@pytest.mark.parametrize("alpha", [0.0, 0.25])
def test_trainer_resume_is_bitwise(alpha):
    """The narrowed gpt-tiny in f32, α 0.25 and 0: 4 steps without a
    break against 2 steps, ``checkpoint.save``, ``restore`` into a fresh
    Trainer (shaped as the saved trees: after an update the params are
    bf16; its data stream advanced past the 2 batches already drawn), 2
    more steps: losses and every param and optimizer leaf bitwise
    equal."""
    def fresh():
        params = tree.tree_map(lambda t: t.float(), Trainer(
            CFG, ScheduleConfig(alpha=alpha), device="cpu").params)
        return Trainer(CFG, ScheduleConfig(alpha=alpha), AdamConfig(lr=1e-3),
                       params=params, device="cpu")
    B, S = 4, 32
    whole = fresh()
    lw = whole.run(4, B, S, log_every=0).losses
    a = fresh()
    la = a.run(2, B, S, log_every=0).losses
    with tempfile.TemporaryDirectory() as d:
        checkpoint.save(d, a.params, a.state, step=a.step_num)
        b = fresh()
        b.params, b.state, b.step_num = checkpoint.restore(d, a.params,
                                                           a.state)
    for _ in range(b.step_num):
        b.data.batch(B, S)
    lb = b.run(2, B, S, log_every=0).losses
    assert la + lb == lw
    _assert_bitwise(b.params, whole.params)
    _assert_bitwise(b.state, whole.state)
