"""The port's plan-vs-actual reconciliation (``repro_torch.obs.reconcile``,
``registry.traffic_maps``, the tracer's route rates) against the
reference's on the CPU.

* Over ``tests/test_obs.py``'s schedule x M x α x R grid under
  recompute, the port's engines (single-rank and data-parallel, from the
  reference engine's initial state) and the reference's engines run the
  same two traced steps; the reconciliation rows — (rank, category,
  route, predicted bytes, measured bytes) — are equal exactly, ``ok``
  equal (and true), the predicted route seconds equal, and the losses
  within 1e-5.
* The same span set fed to both tracers gives the same per-route rates
  (the autotuner's reconcile gate reads ``busy_wall_s``), and the stall
  fold, the per-path conservation check and the rank-count refusal
  agree.
"""
import copy
import tempfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax

from _jax_block_fns import shared_jax_block_fns
from repro.configs.base import ArchConfig as JaxArchConfig
from repro.core.perfmodel import StorageRatios as JaxRatios
from repro.obs import Tracer as JaxTracer
from repro.obs import reconcile as jax_reconcile
from repro.obs import top_stall_stream as jax_top_stall
from repro.obs.reconcile import _check_path_sums as jax_path_sums
from repro.offload import DataParallelOffloadEngine as JaxDPEngine
from repro.offload import OffloadConfig as JaxOffloadConfig
from repro.offload import OffloadEngine as JaxOffloadEngine
from repro_torch.configs.base import ArchConfig
from repro_torch.core.perfmodel import StorageRatios
from repro_torch.data import SyntheticLM
from repro_torch.obs import (STALL_STREAM, Tracer, reconcile,
                             stall_by_stream, top_stall_stream, traffic_maps)
from repro_torch.obs.reconcile import _check_path_sums
from repro_torch.offload import (DataParallelOffloadEngine, OffloadConfig,
                                 OffloadEngine)
from repro_torch.weights import offload_state_from_jax

_ARCH = dict(name="obs-tiny", family="dense", source="test", num_layers=2,
             d_model=32, num_heads=2, num_kv_heads=2, head_dim=16, d_ff=64,
             vocab_size=256, act="gelu")
CFG, JCFG = ArchConfig(**_ARCH), JaxArchConfig(**_ARCH)
MB, S = 1, 16

#: tests/test_obs.py's acceptance grid: schedule x M x α x R (wave needs
#: M % 2 == 0, data-parallel plans are vertical with M % R == 0)
GRID = [(sched, M, alpha, R)
        for sched in ("vertical", "horizontal", "wave")
        for M in (1, 2, 4)
        for alpha in (0.0, 0.5)
        for R in (1, 2)
        if not (sched == "wave" and M % 2)
        and not (R > 1 and (sched != "vertical" or M % R))]


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def state():
    """Both sides start from the reference's key-11 init (its DP engine
    splits the key as its single-rank engine does); the reference
    engines share one set of jitted block functions."""
    with shared_jax_block_fns(), tempfile.TemporaryDirectory() as d:
        je = JaxOffloadEngine(JCFG, JaxOffloadConfig(seq_len=S),
                              jax.random.PRNGKey(11), d)
        st = offload_state_from_jax(je)
        je.close()
        yield st


def _kw(sched, M, alpha):
    return dict(schedule=sched, num_microbatches=M, micro_batch=MB,
                seq_len=S, alpha=alpha,
                wave_size={"vertical": 0, "horizontal": 0, "wave": 2}[sched],
                prefetch_depth=1, trace=True)


def _run(eng, M, steps=2):
    data = SyntheticLM(CFG.vocab_size, seed=0)
    losses = [eng.train_step(data.batch(M * MB, S)) for _ in range(steps)]
    eng.finish()
    snap, plan = eng.metrics_snapshot(), eng.plan
    eng.close()
    return losses, snap, plan


def _rows(rec):
    return [(r.rank, r.category, r.route, r.predicted_bytes,
             r.measured_bytes) for r in rec.rows]


@pytest.mark.parametrize("sched,M,alpha,R", GRID)
def test_reconcile_rows_match_reference(state, sched, M, alpha, R):
    kw = _kw(sched, M, alpha)
    with tempfile.TemporaryDirectory() as d:
        joc = JaxOffloadConfig(ratios=JaxRatios(0.0, 0.0, 0.0), **kw)
        je = (JaxDPEngine(JCFG, joc, jax.random.PRNGKey(11), d, ranks=R)
              if R > 1 else
              JaxOffloadEngine(JCFG, joc, jax.random.PRNGKey(11), d))
        jl, jsnap, jplan = _run(je, M)
    with tempfile.TemporaryDirectory() as d:
        toc = OffloadConfig(ratios=StorageRatios(0.0, 0.0, 0.0), **kw)
        te = (DataParallelOffloadEngine(CFG, toc, 0, d, ranks=R,
                                        params=state, device="cpu")
              if R > 1 else
              OffloadEngine(CFG, toc, 0, d, params=state, device="cpu"))
        tl, tsnap, tplan = _run(te, M)
    jrec, trec = jax_reconcile(jplan, jsnap), reconcile(tplan, tsnap)
    assert trec.rows and _rows(trec) == _rows(jrec)
    assert trec.ok == jrec.ok is True
    assert {r.rank for r in trec.rows} == set(range(R))
    assert trec.steps == jrec.steps == 2
    assert trec.route_seconds_predicted == jrec.route_seconds_predicted
    assert trec.route_seconds_measured          # the traced chunk spans
    assert {s for s, _ in trec.stalls} <= set(STALL_STREAM.values())
    assert trec.path_sum_mismatches == []
    assert [dict(m) for m in traffic_maps(tsnap)] == \
        [dict(m) for m in traffic_maps(jsnap)]
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    # the reference's reconcile reads the port's snapshot as its own
    assert _rows(jax_reconcile(jplan, tsnap)) == _rows(trec)


def _spans(tr):
    """One span set: two overlapped read channels, two serial write
    channels, a queue wait, a plan op and a per-path split."""
    tr.enable()
    tr.record("p0", "ssd->cpu", "io.chunk", 0.0, 2.0, route="ssd->cpu",
              nbytes=100, path=0)
    tr.record("p1", "ssd->cpu", "io.chunk", 0.5, 2.5, route="ssd->cpu",
              nbytes=300, path=1)
    tr.record("p0", "ssd->cpu:wait", "io.queue", 0.0, 1.0,
              route="ssd->cpu", nbytes=100)
    tr.record("p0", "cpu->ssd", "io.chunk", 3.0, 4.0, route="cpu->ssd",
              nbytes=50, path=0)
    tr.record("p1", "cpu->ssd", "io.chunk", 4.0, 5.5, route="cpu->ssd",
              nbytes=70, path=1)
    tr.record("exec", "FWD", "plan", 0.0, 1.0)
    return tr.summary()


def test_tracer_summary_route_rates_match_reference():
    t, j = _spans(Tracer()), _spans(JaxTracer())
    # the port's summary adds its clock anchors (the reference has none)
    assert set(t.pop("clock")) == {"anchors", "drift_ns", "drift_ppm"}
    assert t == j
    assert t["routes"]["ssd->cpu"]["busy_wall_s"] == pytest.approx(2.5)
    assert t["routes"]["ssd->cpu"]["rate_bps"] == pytest.approx(160.0)


@pytest.mark.parametrize("op_s", [
    {}, {"FWD": 9.0},
    {"FETCH_PARAM": 1.0, "ALLGATHER": 0.5, "WAIT_OPT": 0.25, "FWD": 99.0},
    {"FETCH_ACT": 2.0, "FETCH_CKPT_BWD": 1.0, "BARRIER": 0.5},
])
def test_stall_fold_matches_reference(op_s):
    from repro.obs import stall_by_stream as jax_stall_by_stream
    assert stall_by_stream(op_s) == jax_stall_by_stream(op_s)
    assert top_stall_stream(op_s) == jax_top_stall(op_s)


def test_path_sum_check_and_rank_refusal_match_reference(state):
    with tempfile.TemporaryDirectory() as d:
        te = OffloadEngine(CFG, OffloadConfig(
            **_kw("vertical", 2, 0.5), ratios=StorageRatios(0.0, 0.0, 0.0)),
            0, d, params=state, device="cpu")
        _, snap, plan = _run(te, 2, steps=1)
    assert _check_path_sums(snap) == jax_path_sums(snap) == []
    bad = copy.deepcopy(snap)
    route = next(iter(bad["io"][0]["chunk_bytes_by_route"]))
    bad["io"][0]["chunk_bytes_by_route"][route] += 1
    msgs = _check_path_sums(bad)
    assert msgs and msgs == jax_path_sums(bad)
    assert not reconcile(plan, bad).ok
    bad = copy.deepcopy(snap)
    bad["traffic"] = bad["traffic"] * 2         # pretend two ranks
    with pytest.raises(ValueError, match="rank"):
        reconcile(plan, bad)
