"""The port's online autotuner (``repro_torch.offload.autotune``) and its
plan hot swap (``apply_plan_config``) on the CPU, held against the
reference's ``tests/test_autotune.py``.

* ``decide`` parity — one window snapshot from the port's engine,
  scripted as the reference's tests script it, is fed to the port's
  controller and to the reference's controller (on a reference engine
  of the same config): the same decision kind, reason, knob changes and
  candidate list, with predicted iteration times and the route error
  within rtol 1e-6 (both sides solve the same LPs);
* the guards — hysteresis, the reconcile gate, cooldown and the retune
  budget, the committed loop, an invalid knob leaving the engine on its
  plan, and a wave swap equal to an engine compiled with the new plan
  from the same checkpoint;
* trajectory neutrality — autotune on (live depth retunes) vs off over
  ``test_autotune.py``'s schedule x M x α x R grid: bitwise f32 losses
  and parameters.
"""
import copy
import tempfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax

from repro.configs.base import ArchConfig as JaxArchConfig
from repro.core.perfmodel import MachineParams as JaxMachine
from repro.core.perfmodel import StorageRatios as JaxRatios
from repro.offload import AutotuneConfig as JaxAutotuneConfig
from repro.offload import AutotuneController as JaxAutotuneController
from repro.offload import DataParallelOffloadEngine as JaxDPEngine
from repro.offload import OffloadConfig as JaxOffloadConfig
from repro.offload import OffloadEngine as JaxOffloadEngine
from repro.offload import route_seconds_error as jax_route_seconds_error
from repro_torch.configs.base import ArchConfig
from repro_torch.core.perfmodel import MachineParams, StorageRatios
from repro_torch.data import SyntheticLM
from repro_torch.offload import (AutotuneConfig, AutotuneController,
                                 DataParallelOffloadEngine, OffloadConfig,
                                 OffloadEngine, route_seconds_error)

_ARCH = dict(name="autotune-tiny", family="dense", source="test",
             num_layers=2, d_model=32, num_heads=2, num_kv_heads=2,
             head_dim=16, d_ff=64, vocab_size=256, act="gelu")
CFG, JCFG = ArchConfig(**_ARCH), JaxArchConfig(**_ARCH)
MB, S = 1, 16

#: test_autotune.py's grid: schedule x M x α x R (wave needs M % 2 == 0,
#: data-parallel plans are vertical with M % R == 0)
GRID = [(sched, M, alpha, R)
        for sched in ("vertical", "horizontal", "wave")
        for M in (2, 4)
        for alpha in (0.0, 0.5)
        for R in (1, 2)
        if not (sched == "wave" and M % 2)
        and not (R > 1 and (sched != "vertical" or M % R))]

#: test_autotune.py's machine on which the lookahead LP rows bind for the
#: tiny model (slow compute, a host too small to cache the optimizer
#: tail, a slow SSD), and the drifted device's measured rate
_DRIFT = dict(name="drift", gpu_flops=1e7, ssd_read_bw=1e6,
              ssd_write_bw=1e6, cpu_mem=2e5)
DRIFT_MACHINE, JAX_DRIFT_MACHINE = MachineParams(**_DRIFT), \
    JaxMachine(**_DRIFT)
DRIFT_RATE = 1e6


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _kw(sched, M, alpha, depth, wave=None):
    W = {"vertical": 0, "horizontal": 0, "wave": 2}[sched] \
        if wave is None else wave
    return dict(schedule=sched, num_microbatches=M, micro_batch=MB,
                seq_len=S, alpha=alpha, wave_size=W, prefetch_depth=depth)


def _build(sched, M, alpha, R, workdir, depth=1, wave=None):
    ocfg = OffloadConfig(ratios=StorageRatios(0.0, 0.0, 0.0),
                         **_kw(sched, M, alpha, depth, wave))
    if R > 1:
        return DataParallelOffloadEngine(CFG, ocfg, 11, workdir, ranks=R,
                                         device="cpu")
    return OffloadEngine(CFG, ocfg, 11, workdir, device="cpu")


def _build_jax(sched, M, alpha, R, workdir, depth=1):
    ocfg = JaxOffloadConfig(ratios=JaxRatios(0.0, 0.0, 0.0),
                            **_kw(sched, M, alpha, depth))
    if R > 1:
        return JaxDPEngine(JCFG, ocfg, jax.random.PRNGKey(11), workdir,
                           ranks=R)
    return JaxOffloadEngine(JCFG, ocfg, jax.random.PRNGKey(11), workdir)


def _landed(eng):
    """Wait for the window's writes still in flight when ``train_step``
    returns (the optimizer's segments, the checkpoint spills), so that
    the trace holds the chunk spans of every byte they move: under CPU
    contention a snapshot taken while they run sees only part of the
    route seconds, and the reconcile gate then blocks by timing alone.
    Waiting changes no value: the next step waits on the same work."""
    for rk in getattr(eng, "ranks", [eng]):
        rk.opt_c.wait_all()
        rk.ckpt_c.wait_pending()
        rk.act_c.wait_pending()


def _window(eng, steps=2, seed=0):
    """``steps`` measured iterations; the window snapshot, no decision."""
    data = SyntheticLM(CFG.vocab_size, seed=seed)
    M = eng.ocfg.num_microbatches
    for _ in range(steps):
        eng.train_step(data.batch(M * MB, S))
    _landed(eng)
    return eng.metrics_snapshot()


def _script_drift(snap, rate=DRIFT_RATE):
    """The live device got slower than the configured machine: measured
    route rates rewritten, bytes and wall seconds kept consistent so the
    reconcile gate stays green."""
    for d in snap["trace"]["routes"].values():
        if d.get("bytes"):
            d["busy_wall_s"] = d["bytes"] / rate
            d["rate_bps"] = rate
    return snap


def _drift_snapshots(eng):
    """Every window the controller measures looks like the drifted
    device, snapshotted once its I/O has landed."""
    real = eng.metrics_snapshot

    def drifted():
        _landed(eng)
        return _script_drift(real())
    eng.metrics_snapshot = drifted


@pytest.mark.parametrize("pred,meas,floor", [
    ({}, {}, 0.0), ({"ssd->cpu": 1.0}, {}, 0.0),
    ({"ssd->cpu": 1.0}, {"ssd->cpu": 1.0}, 0.0),
    ({"ssd->cpu": 1.0}, {"ssd->cpu": 2.0}, 0.0),
    ({"ssd->cpu": 1.0, "cpu->ssd": 1.0},
     {"ssd->cpu": 1.1, "cpu->ssd": 4.0}, 0.0),
    ({"ssd->cpu": 1e-5}, {"ssd->cpu": 1e-4}, 1e-3),
])
def test_route_seconds_error_matches_reference(pred, meas, floor):
    assert route_seconds_error(pred, meas, floor_s=floor) == \
        jax_route_seconds_error(pred, meas, floor_s=floor)


def test_autotune_config_validates():
    with pytest.raises(ValueError, match="interval"):
        AutotuneConfig(interval=0)
    with pytest.raises(ValueError, match="hysteresis"):
        AutotuneConfig(hysteresis=-0.1)


#: scenario -> (R, depth, AutotuneConfig keywords, drift, setup, action):
#: test_autotune.py's scripted-snapshot branches
SCENARIOS = {
    "hold-current-best": (1, 1, dict(), False, None, "hold"),
    "hold-hysteresis": (1, 0, dict(prefetch_depths=(0, 1), hysteresis=1e9,
                                   machine="drift"), True, None, "hold"),
    "retune-drift": (1, 0, dict(prefetch_depths=(0, 1), hysteresis=0.0,
                                machine="drift"), True, None, "retune"),
    "retune-drift-dp": (2, 0, dict(prefetch_depths=(0, 1), hysteresis=0.0,
                                   machine="drift"), True, None, None),
    "blocked": (1, 0, dict(prefetch_depths=(0, 1), hysteresis=0.0,
                           error_gate=0.5, machine="drift"), True,
                "unexplained", "blocked"),
    "cooldown": (1, 0, dict(prefetch_depths=(0, 1), hysteresis=0.0,
                            cooldown=2), False, "cooldown", "cooldown"),
    "budget": (1, 0, dict(prefetch_depths=(0, 1), hysteresis=0.0,
                          max_retunes=0), False, None, "hold"),
}


def _close_pred(a, b):
    """Predicted seconds: both None (LP-infeasible) or within rtol 1e-6."""
    if a is None or b is None:
        assert a is b is None
    else:
        assert a == pytest.approx(b, rel=1e-6)


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_decide_matches_reference(name):
    R, depth, acfg, drift, setup, action = SCENARIOS[name]
    M, alpha = 2, 0.5
    with tempfile.TemporaryDirectory() as d1, \
            tempfile.TemporaryDirectory() as d2:
        te = _build("vertical", M, alpha, R, d1, depth=depth)
        je = _build_jax("vertical", M, alpha, R, d2, depth=depth)
        tk, jk = dict(acfg), dict(acfg)
        if acfg.get("machine") == "drift":
            tk["machine"], jk["machine"] = DRIFT_MACHINE, JAX_DRIFT_MACHINE
        tc = AutotuneController(te, AutotuneConfig(interval=2, **tk))
        jc = JaxAutotuneController(je, JaxAutotuneConfig(interval=2, **jk))
        snap = _window(te)
        if drift:
            snap = _script_drift(snap)
        if setup == "unexplained":
            # 1000 s on a route the plan predicts in microseconds
            snap["trace"]["routes"]["cpu->ssd"]["busy_wall_s"] = 1000.0
        if setup == "cooldown":
            tc._cooldown = jc._cooldown = 2
        td = tc.decide(copy.deepcopy(snap), steps=2)
        jd = jc.decide(copy.deepcopy(snap), steps=2)
        assert te.ocfg.resolved_prefetch_depth() == depth  # decide is pure
        te.close()
        je.close()
    for key in ("action", "reason", "changes", "window", "machine"):
        assert td.get(key) == jd.get(key), key
    assert set(td) == set(jd)
    if "route_error" in td:
        assert td["route_error"] == pytest.approx(jd["route_error"],
                                                  rel=1e-6, abs=1e-12)
    assert len(td.get("candidates", [])) == len(jd.get("candidates", []))
    for a, b in zip(td.get("candidates", []), jd.get("candidates", [])):
        assert {k: a[k] for k in a if k != "pred_s"} == \
            {k: b[k] for k in b if k != "pred_s"}
        _close_pred(a["pred_s"], b["pred_s"])
    for key in ("current", "best"):
        if key in td:
            _close_pred(td[key]["pred_s"], jd[key]["pred_s"])
    if td.get("predicted_win") is not None:
        assert td["predicted_win"] == pytest.approx(jd["predicted_win"],
                                                    rel=1e-6)
    # the reference's guard assertions, on the port's decision
    if action is not None:
        assert td["action"] == action
    if name == "hold-current-best":
        assert td["best"] == td["current"]
    elif name == "hold-hysteresis":
        assert "hysteresis" in td["reason"] and td["predicted_win"] > 1.0
    elif name == "retune-drift":
        assert td["changes"] == {"prefetch_depth": 1}
        assert td["best"]["pred_s"] < td["current"]["pred_s"]
        assert td["candidates"][0]["depth"] == 0
    elif name == "blocked":
        assert td["route_error"] > 0.5 and "candidates" not in td
    elif name == "budget":
        assert "budget" in td["reason"]


def test_post_step_loop_swaps_once_then_cools_down():
    """One retune fires, the cooldown window follows, the swap landed on
    the engine, and the decision log rides in the next snapshot."""
    with tempfile.TemporaryDirectory() as d:
        eng = _build("vertical", 2, 0.5, 1, d, depth=0)
        _drift_snapshots(eng)
        ctl = AutotuneController(
            eng, AutotuneConfig(interval=1, prefetch_depths=(0, 1),
                                hysteresis=0.0, cooldown=1,
                                max_retunes=1, machine=DRIFT_MACHINE))
        data = SyntheticLM(CFG.vocab_size, seed=0)
        decisions = []
        for _ in range(4):
            eng.train_step(data.batch(2 * MB, S))
            dec = ctl.post_step()
            assert dec is not None                  # interval=1
            decisions.append(dec)
        actions = [dc["action"] for dc in decisions]
        assert actions[0] == "retune" and actions[1] == "cooldown"
        assert set(actions[2:]) <= {"hold", "blocked"}
        assert ctl.retunes == 1
        assert eng.ocfg.resolved_prefetch_depth() == 1   # swap landed
        assert decisions[0]["paths"][0]["least_loaded_path"] >= 0
        assert decisions[0]["paths"][0]["imbalance"] >= 0.0
        eng.finish()
        assert [dc["action"] for dc in eng.metrics_snapshot()["autotune"]] \
            == actions
        eng.close()


@pytest.mark.parametrize("R", [1, 2])
def test_apply_plan_config_invalid_knob_is_atomic(R):
    """Validate, then commit: a bad knob raises and the engine keeps
    training on its current plan and config."""
    with tempfile.TemporaryDirectory() as d:
        eng = (_build("wave", 4, 0.0, 1, d, depth=1, wave=2) if R == 1
               else _build("vertical", 4, 0.0, 2, d, depth=1))
        plan = eng.plan
        data = SyntheticLM(CFG.vocab_size, seed=0)
        eng.train_step(data.batch(4 * MB, S))
        bad = [dict(activation_policy="levitate"),
               dict(prefetch_depth=99), dict(path_policy="teleport")]
        if R == 1:
            bad.append(dict(wave_size=3))           # 3 does not divide 4
        for kw in bad:
            with pytest.raises(ValueError):
                eng.apply_plan_config(**kw)
        assert eng.plan is plan
        assert eng.ocfg.resolved_wave_size() == (2 if R == 1 else 4)
        assert eng.ocfg.prefetch_depth == 1
        assert eng.act_policy == "recompute"
        assert np.isfinite(eng.train_step(data.batch(4 * MB, S)))
        eng.apply_plan_config(path_policy="backlog")
        ranks = eng.ranks if R > 1 else [eng]
        assert {rk.ioe.path_policy for rk in ranks} == {"backlog"}
        eng.close()


def test_wave_swap_bitwise_equals_recompile_from_checkpoint():
    """2 steps -> ``apply_plan_config(wave 2 -> 4)`` -> 2 steps equals,
    bitwise, an engine built with the second plan and restored from a
    checkpoint of the same first half: the swap leaks no per-plan
    state."""
    data = SyntheticLM(CFG.vocab_size, seed=0)
    batches = [data.batch(4 * MB, S) for _ in range(4)]
    with tempfile.TemporaryDirectory() as da, \
            tempfile.TemporaryDirectory() as db, \
            tempfile.TemporaryDirectory() as dc, \
            tempfile.TemporaryDirectory() as ck:
        a = _build("wave", 4, 0.5, 1, da, depth=1, wave=2)
        losses_a = [a.train_step(b) for b in batches[:2]]
        a.apply_plan_config(wave_size=4)
        assert not a.params_c._gate              # the seam cleared the gates
        assert a.ocfg.resolved_wave_size() == 4
        losses_a += [a.train_step(b) for b in batches[2:]]
        a.finish()
        params_a = [a.p_vecs[l].read().copy() for l in range(a.L)]
        a.close()

        b_eng = _build("wave", 4, 0.5, 1, db, depth=1, wave=2)
        losses_b = [b_eng.train_step(b) for b in batches[:2]]
        assert losses_b == losses_a[:2]
        b_eng.save_checkpoint(ck)
        b_eng.close()

        c = _build("wave", 4, 0.5, 1, dc, depth=1, wave=4)
        assert c.restore_checkpoint(ck) == b_eng.step_num
        losses_c = [c.train_step(b) for b in batches[2:]]
        c.finish()
        params_c = [c.p_vecs[l].read().copy() for l in range(c.L)]
        c.close()
    assert losses_a[2:] == losses_c
    for pa, pc in zip(params_a, params_c):
        assert np.array_equal(pa, pc)


@pytest.mark.parametrize("sched,M,alpha,R", GRID)
def test_autotune_on_vs_off_bitwise(sched, M, alpha, R):
    """Autotune on (live depth retunes from measured windows) vs off:
    the same f32 losses and bitwise parameters on every grid cell."""
    steps = 3

    def run(autotune):
        with tempfile.TemporaryDirectory() as d:
            eng = _build(sched, M, alpha, R, d, depth=0)
            ctl = None
            if autotune:
                _drift_snapshots(eng)
                ctl = AutotuneController(
                    eng, AutotuneConfig(interval=1, hysteresis=0.0,
                                        cooldown=0, machine=DRIFT_MACHINE,
                                        prefetch_depths=(0, 1, 2)))
            data = SyntheticLM(CFG.vocab_size, seed=0)
            losses = []
            for _ in range(steps):
                losses.append(eng.train_step(data.batch(M * MB, S)))
                if ctl is not None:
                    ctl.post_step()
            eng.finish()
            params = [eng.read_params(l) if R > 1
                      else eng.p_vecs[l].read().copy() for l in range(eng.L)]
            retunes = ctl.retunes if ctl is not None else 0
            eng.close()
        return losses, params, retunes

    l_off, p_off, _ = run(autotune=False)
    l_on, p_on, retunes = run(autotune=True)
    assert l_off == l_on
    for a, b in zip(p_off, p_on):
        assert np.array_equal(a, b)
    # the cells whose serialized depth-0 reads carry an α tail must have
    # retuned, so the bitwise check covers a mid-training swap
    if sched == "vertical" and alpha > 0.0 and R == 1:
        assert retunes >= 1
