"""The port's in-memory training front door on the CPU against the JAX
reference: ``data.split_microbatches``, ``train.Trainer`` from the JAX
Trainer's weights, the port's own loss-decrease and delayed-optimizer
checks at the reference's sizes, and the training CLI
(``repro_torch.launch.train``) in memory and under ``--offload`` (its
engine against the JAX CLI's engine from the same weights)."""
import tempfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.configs import get_config as jax_config
from repro.core import ScheduleConfig as JaxSched
from repro.core.perfmodel import StorageRatios as JaxRatios
from repro.data import split_microbatches as jax_split
from repro.offload import OffloadConfig as JaxOffloadConfig
from repro.offload import OffloadEngine as JaxOffloadEngine
from repro.optim import AdamConfig as JaxAdam
from repro.optim import init_delayed as jax_init_delayed
from repro.optim import init_state as jax_init_state
from repro.train import Trainer as JaxTrainer
from repro_torch.configs import get_config
from repro_torch.core import ScheduleConfig
from repro_torch.data import SyntheticLM, split_microbatches
from repro_torch.launch import train as cli
from repro_torch.optim import AdamConfig
from repro_torch.train import Trainer
from repro_torch.weights import offload_state_from_jax, params_from_jax

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


def test_split_microbatches_matches_reference():
    """(M, B/M, ...) splits of a token batch and a float frontend batch,
    element for element the reference's; a batch that does not divide
    is refused."""
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, 100, (8, 32), dtype=np.int32),
             "enc": rng.standard_normal((8, 5, 3)).astype(np.float32)}
    for m in (1, 2, 4, 8):
        want = jax_split({k: jnp.asarray(v) for k, v in batch.items()}, m)
        got = split_microbatches({k: torch.from_numpy(v)
                                  for k, v in batch.items()}, m)
        for k in batch:
            assert tuple(got[k].shape) == want[k].shape
            np.testing.assert_array_equal(got[k].numpy(),
                                          np.asarray(want[k]))
    with pytest.raises(ValueError):
        split_microbatches({"tokens": torch.zeros(6, 4)}, 4)


def _record_grad_norms(trainer, out):
    """Keep every step's exact pre-clip gradient norm (the Trainers log
    it rounded to 3 decimals)."""
    step = trainer._step

    def recorded(*a):
        r = step(*a)
        out.append(float(r[2]["grad_norm"]))
        return r
    trainer._step = recorded


#: After its first optimizer update every Trainer trains bf16 parameters
#: cast from its f32 masters (both packages' ``apply_update`` /
#: ``flush_late``), and XLA's CPU products and torch's round bf16 inputs
#: and partial sums differently. So those steps are held at the engine
#: tests' bf16 loss tolerance and, because the vertical schedule's
#: gradients are bf16 leaves, at test_torch_train.py's 1e-3 on the
#: gradient norm (measured: 9.0e-5 and 6.7e-4 at most). Only what runs on
#: f32 parameters (step 1 of the undelayed runs from f32 weights) is held
#: at the f32 1e-5 (measured: 0 and 1.9e-7).
F32_RTOL, BF16_LOSS_RTOL, BF16_GNORM_RTOL = 1e-5, 2e-4, 1e-3


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sched", [
    dict(schedule="vertical"), dict(schedule="vertical", alpha=0.4),
    dict(schedule="horizontal", num_microbatches=2)],
    ids=["vertical", "vertical-alpha0.4", "horizontal-M2"])
def test_trainer_matches_jax_trainer(sched, dtype):
    """The port's ``Trainer`` from the JAX Trainer's weights
    (``params_from_jax``), gpt-tiny, 4 steps of 8 x 64 tokens each, the
    same seeded data stream: per-step losses and gradient norms within
    the tolerances above. In f32 both Trainers' params and states are
    set to f32 first."""
    jt = JaxTrainer(JCFG, JaxSched(**sched), JaxAdam(lr=1e-3), seed=0)
    if dtype == "float32":
        jt.params = jax.tree.map(lambda x: x.astype(jnp.float32), jt.params)
        opt = jax_init_state(jt.params)
        jt.state = (jax_init_delayed(opt, jax.tree.map(
            lambda p: jnp.zeros(p.shape, jnp.float32), jt.params))
            if jt.delayed else opt)
    tt = Trainer(CFG, ScheduleConfig(**sched), AdamConfig(lr=1e-3), seed=0,
                 params=params_from_jax(jax.tree.map(np.asarray,
                                                     jt.params)),
                 device="cpu")
    jg, tg = [], []
    _record_grad_norms(jt, jg)
    _record_grad_norms(tt, tg)
    jr = jt.run(4, 8, 64, log_every=0)
    tr = tt.run(4, 8, 64, log_every=0)
    assert tt.step_num == jt.step_num == 4
    f32_steps = 1 if dtype == "float32" and not tt.delayed else 0
    np.testing.assert_allclose(tr.losses[:f32_steps], jr.losses[:f32_steps],
                               rtol=F32_RTOL)
    np.testing.assert_allclose(tg[:f32_steps], jg[:f32_steps], rtol=F32_RTOL)
    np.testing.assert_allclose(tr.losses, jr.losses, rtol=BF16_LOSS_RTOL)
    np.testing.assert_allclose(tg, jg, rtol=BF16_GNORM_RTOL)
    assert tr.losses[3] != tr.losses[0]


def test_loss_decreases_vertical():
    """tests/test_train_integration.py's check on the port: 40 vertical
    steps of 16 x 64 tokens at lr 3e-3 take the mean of the last five
    losses more than 1.0 below the first."""
    tr = Trainer(CFG, ScheduleConfig(schedule="vertical"),
                 AdamConfig(lr=3e-3), device="cpu")
    rep = tr.run(40, batch_size=16, seq_len=64, log_every=0)
    assert np.mean(rep.losses[-5:]) < rep.losses[0] - 1.0, rep.losses[::8]
    assert rep.steps_per_s > 0 and rep.tokens_per_s == pytest.approx(
        rep.steps_per_s * 16 * 64)


def test_delayed_trainer_matches_plain():
    """tests/test_train_integration.py's check on the port: α = 0.4 and
    α = 0 over 6 steps from the same seed agree within 2e-3."""
    t1 = Trainer(CFG, ScheduleConfig(schedule="vertical"),
                 AdamConfig(lr=1e-3), seed=0, device="cpu")
    r1 = t1.run(6, batch_size=8, seq_len=64, log_every=0)
    t2 = Trainer(CFG, ScheduleConfig(schedule="vertical", alpha=0.4),
                 AdamConfig(lr=1e-3), seed=0, device="cpu")
    r2 = t2.run(6, batch_size=8, seq_len=64, log_every=0)
    np.testing.assert_allclose(r1.losses, r2.losses, atol=2e-3)
    assert r1.losses != r2.losses


def test_cli_in_memory_is_the_trainer(capsys):
    """``launch.train.main`` in memory on the CPU: the reference CLI's
    lines, and losses bitwise those of a ``Trainer`` with the CLI's
    schedule, α, learning rate, batch and seed."""
    argv = ["--arch", "gpt-tiny", "--steps", "2", "--batch", "4", "--seq",
            "32", "--alpha", "0.25", "--device", "cpu"]
    out = cli.main(argv)
    printed = capsys.readouterr().out
    assert "step     1 loss" in printed and "final loss" in printed
    tr = Trainer(CFG, ScheduleConfig(num_microbatches=4, alpha=0.25),
                 AdamConfig(lr=1e-3), device="cpu")
    assert out["losses"] == tr.run(2, 4, 32, log_every=0).losses
    assert out["tokens_per_s"] > 0


#: the offload CLI's loss tolerance against the JAX CLI's engine: f32
#: engine parameters (both CLIs' default), so the engine tests' f32 1e-5
CLI_OFFLOAD_RTOL = 1e-5


def test_cli_offload_matches_jax_cli_engine(monkeypatch, tmp_path):
    """``launch.train.main --offload`` on the CPU at its defaults (gpt-tiny,
    8 x 128 tokens as 4 micro-batches, vertical, α 0, ratios 0.5 / 0.5 /
    0), 2 steps, started from the weights of the engine the JAX CLI
    builds (``PRNGKey(0)``; the test hands them to the port's CLI in
    place of its seed-0 init): losses within 1e-5 relative, the byte
    meters exactly the reference engine's, and exactly the returned
    ``plan_traffic`` x 2."""
    argv = ["--arch", "gpt-tiny", "--steps", "2", "--offload"]
    args = cli.parse_args(argv)
    ocfg = JaxOffloadConfig(
        schedule=args.schedule, num_microbatches=args.microbatches,
        micro_batch=args.batch // args.microbatches, seq_len=args.seq,
        alpha=args.alpha, lr=args.lr,
        ratios=JaxRatios(args.x_ckpt, args.x_param, args.x_opt))
    with tempfile.TemporaryDirectory() as d:
        je = JaxOffloadEngine(JCFG, ocfg, jax.random.PRNGKey(0), d)
        state = offload_state_from_jax(je)
        je.meter.reset()            # reading the state out is metered
        data = SyntheticLM(JCFG.vocab_size, seed=0)
        jl = [je.train_step(data.batch(args.batch, args.seq))
              for _ in range(args.steps)]
        je.finish()
        jt = je.meter.snapshot()
        je.close()
    monkeypatch.setattr(cli, "offload_state", lambda cfg, params: state)
    out = cli.main(argv + ["--device", "cpu", "--ssd-dir", str(tmp_path)])
    np.testing.assert_allclose(out["losses"], jl, rtol=CLI_OFFLOAD_RTOL)
    assert out["traffic"] == jt
    assert {f"{c}:{r}": 2 * v for (c, r), v in
            out["plan_traffic"].items()} == out["traffic"]


def test_entry_points_raise_without_a_card():
    """Without a card the Trainer and the CLI raise at their default
    device instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(CFG, ScheduleConfig())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["--steps", "1"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["--steps", "1", "--offload"])
    # an unknown architecture names the port's (the hybrid family among
    # them)
    with pytest.raises(KeyError, match="jamba-v0.1-52b"):
        cli.main(["--arch", "no-such-arch", "--device", "cpu"])
