"""The port's data-parallel offload engine
(``repro_torch.offload.dp.DataParallelOffloadEngine``: R simulated ranks,
each with its own host store, I/O engine and SSD path set) on the CPU.

* against the reference's ``DataParallelOffloadEngine`` from the same
  initial state (``weights.offload_state_from_jax``), R = 2 and 4:
  per-step losses within 1e-5, and every rank's byte meters and
  ``plan_traffic`` map exactly the reference's;
* against the port's own single-rank ``OffloadEngine`` from one seed:
  losses and final parameters and masters bitwise equal in f32 (R = 2
  and 4, α 0 and 0.5, both activation policies), and in bf16;
* every rank's meters equal ``dp_vertical_traffic``'s closed forms;
* the ranks drive disjoint path sets; uneven micro-batch counts and
  non-vertical schedules are refused.
"""
import os
import tempfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax

from _jax_block_fns import shared_jax_block_fns
from repro.configs import get_config as jax_config
from repro.core.perfmodel import StorageRatios as JaxRatios
from repro.core.plan import PlanCosts as JaxPlanCosts
from repro.core.plan import plan_traffic as jax_plan_traffic
from repro.offload import DataParallelOffloadEngine as JaxDPEngine
from repro.offload import OffloadConfig as JaxOffloadConfig
from repro.offload import OffloadEngine as JaxOffloadEngine
from repro_torch.configs import get_config
from repro_torch.core.perfmodel import StorageRatios
from repro_torch.core.plan import PlanCosts, plan_traffic
from repro_torch.core.traffic import dp_vertical_traffic
from repro_torch.data import SyntheticLM
from repro_torch.io import IOConfig
from repro_torch.offload import (DataParallelOffloadEngine, OffloadConfig,
                                 OffloadEngine, shard_bounds)
from repro_torch.weights import offload_state_from_jax

CFG = get_config("gpt-tiny")
JCFG = jax_config("gpt-tiny")
M, MB, S = 4, 2, 64     # tests/test_dp_offload.py's engine shape


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ocfg(alpha=0.0, ratios=StorageRatios(0.5, 0.5, 0.5), **kw):
    return OffloadConfig(schedule="vertical", num_microbatches=M,
                         micro_batch=MB, seq_len=S, alpha=alpha,
                         ratios=ratios, **kw)


def _batches(steps):
    data = SyntheticLM(CFG.vocab_size, seed=0)
    return [data.batch(M * MB, S) for _ in range(steps)]


def _run(ranks, batches, ocfg, params=None):
    """(losses, per-rank meter maps, per-rank plan_traffic, final params,
    final masters) of one port run; ``ranks=0`` is the single-rank
    engine."""
    with tempfile.TemporaryDirectory() as d:
        if ranks == 0:
            eng = OffloadEngine(CFG, ocfg, 7, d, params=params, device="cpu")
        else:
            eng = DataParallelOffloadEngine(CFG, ocfg, 7, d, ranks=ranks,
                                            params=params, device="cpu")
        losses = [eng.train_step(b) for b in batches]
        eng.finish()
        pred = plan_traffic(eng.plan, PlanCosts.from_engine(eng))
        if ranks == 0:
            meters, pred = [dict(eng.meter.bytes)], [pred]
            params_ = [eng.p_vecs[l].read() for l in range(eng.L)]
            masters = [eng.m_master[l].read() for l in range(eng.L)]
        else:
            meters = [dict(rk.meter.bytes) for rk in eng.ranks]
            params_ = [eng.read_params(l) for l in range(eng.L)]
            masters = [np.concatenate([rk.m_master[l].read()
                                       for rk in eng.ranks])
                       for l in range(eng.L)]
        eng.close()
    return losses, meters, [dict(p) for p in pred], params_, masters


@pytest.mark.parametrize("R,alpha,steps", [(2, 0.5, 2), (4, 0.0, 1)])
def test_dp_matches_reference_dp_engine(R, alpha, steps):
    """Same initial state on both sides (the reference's DP engine
    splits its key as its single-rank engine does): losses within 1e-5,
    each rank's measured meters and ``plan_traffic`` equal the
    reference's exactly, and the port's meters equal its own
    ``plan_traffic`` x steps."""
    batches = _batches(steps)
    with shared_jax_block_fns(), tempfile.TemporaryDirectory() as d:
        je = JaxOffloadEngine(JCFG, JaxOffloadConfig(seq_len=S),
                              jax.random.PRNGKey(7), d)
        state = offload_state_from_jax(je)
        je.close()
        je = JaxDPEngine(JCFG, JaxOffloadConfig(
            schedule="vertical", num_microbatches=M, micro_batch=MB,
            seq_len=S, alpha=alpha, ratios=JaxRatios(0.5, 0.5, 0.5)),
            jax.random.PRNGKey(7), d, ranks=R)
        jl = [je.train_step(b) for b in batches]
        je.finish()
        jm = [dict(rk.meter.bytes) for rk in je.ranks]
        jpred = [dict(p) for p in
                 jax_plan_traffic(je.plan, JaxPlanCosts.from_engine(je))]
        je.close()
    tl, tm, tpred, _, _ = _run(R, batches, _ocfg(alpha), params=state)
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert len(tm) == R
    assert tm == jm
    assert tpred == jpred
    assert tm == [{k: steps * v for k, v in p.items()} for p in tpred]


@pytest.mark.parametrize("R,alpha,kw", [
    (2, 0.0, {}), (2, 0.5, {}), (4, 0.0, {}),
    (2, 0.5, {"activation_policy": "spill"}),
    (2, 0.25, {"param_dtype": "bfloat16"}),
])
def test_dp_bitwise_equals_single_rank(R, alpha, kw):
    """R ranks == one rank, bit for bit: the reduce-scatter folds the
    per-micro-batch gradients in the single-rank engine's order, and
    the host Adam commutes with slicing."""
    batches = _batches(2)
    ocfg = _ocfg(alpha, ratios=StorageRatios(0.5, 0.5, 0.5, act=0.5), **kw)
    l1, _, _, p1, m1 = _run(0, batches, ocfg)
    lr, meters, pred, pr, mr = _run(R, batches, ocfg)
    assert lr == l1                               # Python floats: bitwise
    for layer, (a, b, c, e) in enumerate(zip(p1, pr, m1, mr)):
        np.testing.assert_array_equal(a, b, err_msg=f"params {layer}")
        np.testing.assert_array_equal(c, e, err_msg=f"masters {layer}")
    assert meters == [{k: 2 * v for k, v in p.items()} for p in pred]


def test_dp_per_rank_counters_match_closed_form():
    """Fully offloaded (every ratio 0): each rank's per-step meters equal
    ``dp_vertical_traffic``'s closed forms exactly."""
    steps, R = 2, 2
    _, per_rank, _, _, _ = _run(R, _batches(steps),
                                _ocfg(0.5, StorageRatios(0.0, 0.0, 0.0)))
    with tempfile.TemporaryDirectory() as d:
        eng = OffloadEngine(CFG, _ocfg(), 7, d, device="cpu")
        L, P = eng.L, eng.P
        eng.close()
    ms = L * P * 4
    cs = L * MB * S * CFG.d_model * 4
    t = dp_vertical_traffic(ms, cs, M, R, grad_bytes=ms, os_bytes=3 * ms,
                            n_layers=L)
    head = 4 * (2 * CFG.padded_vocab * CFG.d_model + CFG.d_model)
    for r, routes in enumerate(per_rank):
        got = {k: v / steps for k, v in routes.items()}
        want = {
            ("param", "cpu->gpu"): t.param_fetch,
            ("param", "ssd->cpu"): t.param_fetch,
            ("param", "net->gpu"): t.param_allgather,
            ("param", "gpu->net"): t.param_allgather,
            ("param", "cpu->ssd"): t.param_writeback,
            ("grad", "gpu->cpu"): t.grad_offload,
            ("grad", "net->gpu"): t.grad_reducescatter,
            ("grad", "gpu->net"): t.grad_reducescatter,
            ("opt", "ssd->cpu"): t.opt_read,
            ("opt", "cpu->ssd"): t.opt_write,
            ("ckpt", "gpu->cpu"): t.ckpt.write,
            ("ckpt", "cpu->gpu"): t.ckpt.read,
            ("ckpt", "cpu->ssd"): t.ckpt.ssd_spill,
            ("ckpt", "ssd->cpu"): t.ckpt.ssd_reread,
            ("inter_grad", "gpu->cpu"): t.ckpt.inter_grad / 2,
            ("inter_grad", "cpu->gpu"): t.ckpt.inter_grad / 2,
            ("head_grad", "gpu->net"): 2 * (R - 1) * head // R,
            ("head_grad", "net->gpu"): 2 * (R - 1) * head // R,
        }
        assert set(got) == set(want), r
        for key, expect in want.items():
            assert got[key] == expect, (r, key, got[key], expect)


def test_dp_ranks_drive_disjoint_path_sets():
    """``IOConfig.shard_for_rank`` hands rank r paths r, r+R, ...:
    stripes land only on the owning rank's paths, and ``close()``
    cleans every path."""
    with tempfile.TemporaryDirectory() as d:
        paths = [os.path.join(d, f"nvme{i}") for i in range(4)]
        eng = DataParallelOffloadEngine(
            CFG, _ocfg(io=IOConfig(paths=paths, chunk_bytes=1 << 16)), 7, d,
            ranks=2, device="cpu")
        assert [list(rk.ioe.paths) for rk in eng.ranks] == \
            [[paths[0], paths[2]], [paths[1], paths[3]]]
        eng.train_step(_batches(1)[0])
        eng.finish()
        for p in paths:
            assert os.listdir(p), f"no stripes on {p}"
        snap = eng.metrics_snapshot()
        assert snap["ranks"] == 2 and len(snap["traffic"]) == 2
        assert snap["bounds"] == [list(b) for b in shard_bounds(eng.P, 2)]
        eng.close()
        for p in paths:
            assert os.listdir(p) == [], f"close() left stripes on {p}"


def test_dp_refuses_uneven_microbatches_and_other_schedules():
    with tempfile.TemporaryDirectory() as d:
        with pytest.raises(ValueError, match="divide evenly"):
            DataParallelOffloadEngine(CFG, _ocfg(), 7, d, ranks=3,
                                      device="cpu")
        with pytest.raises(ValueError, match="vertical"):
            DataParallelOffloadEngine(
                CFG, OffloadConfig(schedule="horizontal", num_microbatches=M,
                                   micro_batch=MB, seq_len=S), 7, d,
                ranks=2, device="cpu")
        assert os.listdir(d) == []
