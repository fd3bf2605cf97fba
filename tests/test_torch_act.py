"""The port's activation-spill stream on the CPU: twins of
``tests/test_act_stream.py`` and ``tests/test_act_faults.py`` without the
data-parallel cases, plus the port's engine against the reference's
under ``activation_policy="spill"``.

* spill == recompute bitwise (f32 losses and final parameters) over the
  schedule x M x W x alpha sweep, the measured meters == the port's own
  ``plan_traffic`` == the closed forms exactly, ``act`` included;
* the port's spill engine against the JAX engine's from the same state:
  losses within 1e-5 (f32) / 2e-4 (bf16), every non-``act`` meter exact
  (the ``act`` payload is the port's own: autograd's saved tensors, not
  JAX's vjp residuals, so its size differs and is held against the
  port's ``plan_traffic`` instead);
* act write / read faults degrade one micro-batch to recompute, bitwise;
  the staging pool and the coordinator are left clean;
* ``"auto"`` picks what the reference's ``pick_activation_policy`` picks.
"""
import dataclasses
import tempfile
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax

from repro.configs import get_config as jax_config
from repro.core.perfmodel import MachineParams as JaxMachine
from repro.core.perfmodel import StorageRatios as JaxRatios
from repro.core.perfmodel import Workload as JaxWorkload
from repro.core.perfmodel import \
    pick_activation_policy as jax_pick_activation_policy
from repro.offload import OffloadConfig as JaxOffloadConfig
from repro.offload import OffloadEngine as JaxOffloadEngine
from repro_torch.configs import get_config
from repro_torch.configs.base import ArchConfig
from repro_torch.core.perfmodel import (MachineParams, StorageRatios,
                                        Workload, iteration_time_vertical,
                                        pick_activation_policy)
from repro_torch.core.plan import (Op, PlanCosts, PlanSpec, compile_wave,
                                   insert_prefetch, plan_traffic)
from repro_torch.core.traffic import act_spill_traffic, wave_ckpt_traffic
from repro_torch.data import SyntheticLM
from repro_torch.io import (CATEGORY_PRIORITY, IOConfig, IOEngine, IOPriority,
                            install_chaos)
from repro_torch.offload import (ActivationCoordinator, HostStore,
                                 LayerResiduals, OffloadConfig,
                                 OffloadEngine, SSDStore, TrafficMeter)
from repro_torch.offload.engine import resolve_activation_policy
from repro_torch.weights import offload_state_from_jax

CFG = ArchConfig(name="act-tiny", family="dense", source="test",
                 num_layers=2, d_model=32, num_heads=2, num_kv_heads=2,
                 head_dim=16, d_ff=64, vocab_size=256, act="gelu")
MB, S = 1, 16
X0 = StorageRatios(0.0, 0.0, 0.0)


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """These shapes gain nothing from torch's intra-op threads, and under
    the parallel test workers every process's thread team contends for
    the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run(policy, sched, M, W=0, alpha=0.0, steps=2, ratios=X0, seed=7):
    """(losses, per-step measured routes, plan_traffic, final params,
    act_nbytes) for one port engine run on the CPU."""
    ocfg = OffloadConfig(schedule=sched, num_microbatches=M,
                         micro_batch=MB, seq_len=S, alpha=alpha,
                         wave_size=W, ratios=ratios,
                         activation_policy=policy)
    with tempfile.TemporaryDirectory() as d:
        eng = OffloadEngine(CFG, ocfg, seed, d, device="cpu")
        data = SyntheticLM(CFG.vocab_size, seed=0)
        losses = [eng.train_step(data.batch(M * MB, S))
                  for _ in range(steps)]
        eng.finish()
        measured = {k: v / steps for k, v in eng.meter.bytes.items()}
        pred = plan_traffic(eng.plan, PlanCosts.from_engine(eng))
        params = [eng.p_vecs[l].read().copy() for l in range(eng.L)]
        A = eng.act_nbytes
        assert eng.act_fallbacks == 0      # clean runs never degrade
        eng.close()
    return losses, measured, pred, params, A


def _closed_form_spill(L, P, M, W, A):
    """Exact (category, route) bytes for the f32 spill engine at
    x = (0,0,0,0): the act stream + the ckpt forms with backward
    re-reads gone + the unchanged param/grad/opt forms."""
    ms = L * P * 4
    u = MB * S * CFG.d_model * 4
    nw = M // W
    ct = wave_ckpt_traffic(L * u, M, W, L, act_spill=True)
    at = act_spill_traffic(A, M, L)
    exp = {
        ("param", "ssd->cpu"): 2 * nw * ms,
        ("param", "cpu->gpu"): 2 * nw * ms,
        ("param", "cpu->ssd"): ms,
        ("grad", "gpu->cpu"): nw * ms,
        ("grad", "cpu->gpu"): (nw - 1) * ms,
        ("opt", "ssd->cpu"): 3 * ms,
        ("opt", "cpu->ssd"): 3 * ms,
        ("ckpt", "gpu->cpu"): ct.write,
        ("ckpt", "cpu->gpu"): ct.read,
        ("ckpt", "cpu->ssd"): ct.ssd_spill,
        ("ckpt", "ssd->cpu"): ct.ssd_reread,
        ("inter_grad", "gpu->cpu"): ct.inter_grad / 2,
        ("inter_grad", "cpu->gpu"): ct.inter_grad / 2,
        ("act", "gpu->cpu"): at.spill,
        ("act", "cpu->gpu"): at.fetch,
        ("act", "cpu->ssd"): at.ssd_spill,
        ("act", "ssd->cpu"): at.ssd_reread,
    }
    return {k: v for k, v in exp.items() if v}


# ---------------------------------------------------------------------------
# IR units: ops, compiler, lookahead
# ---------------------------------------------------------------------------

def test_act_priority_is_opportunistic():
    assert IOPriority.ACT > IOPriority.CKPT_SPILL
    assert max(IOPriority) == IOPriority.ACT
    assert CATEGORY_PRIORITY["act"] is IOPriority.ACT


@pytest.mark.parametrize("W", [1, 2, 4])
def test_spill_compiler_ops(W):
    """One SPILL_ACT per (layer, micro-batch) right after its FWD,
    FETCH_ACT replacing FETCH_CKPT_BWD one for one; recompute plans carry
    no act ops."""
    L, M = 3, 4
    plan = compile_wave(PlanSpec(L=L, M=M, act_spill=True), W)
    assert plan.count(Op.SPILL_ACT) == plan.count(Op.FETCH_ACT) == L * M
    assert plan.count(Op.FETCH_CKPT_BWD) == 0
    assert plan.count(Op.FWD) == plan.count(Op.BWD) == L * M
    ops = plan.ops
    for i, op in enumerate(ops):
        if op.op is Op.FWD:
            assert ops[i + 1].op is Op.SPILL_ACT
            assert (ops[i + 1].l, ops[i + 1].m) == (op.l, op.m)
    base = compile_wave(PlanSpec(L=L, M=M), W)
    for kind in (Op.SPILL_ACT, Op.FETCH_ACT, Op.PREFETCH_ACT):
        assert base.count(kind) == 0
    assert base.count(Op.FETCH_CKPT_BWD) == L * M


def test_act_prefetch_hints():
    """One PREFETCH_ACT per FETCH_ACT, before it, never across a
    RESET_PARAMS."""
    L, M = 3, 4
    plan = insert_prefetch(compile_wave(PlanSpec(L=L, M=M, act_spill=True),
                                        M))
    assert plan.count(Op.PREFETCH_ACT) == plan.count(Op.FETCH_ACT) == L * M
    assert plan.count(Op.PREFETCH) == plan.count(Op.FETCH_PARAM)
    ops = plan.ops
    resets = {i for i, op in enumerate(ops) if op.op is Op.RESET_PARAMS}
    hints = {}
    for i, op in enumerate(ops):
        if op.op is Op.PREFETCH_ACT:
            assert (op.l, op.m) not in hints
            hints[(op.l, op.m)] = i
        elif op.op is Op.FETCH_ACT:
            h = hints.pop((op.l, op.m))
            assert h < i
            assert not any(h < r < i for r in resets)
    assert not hints
    base = insert_prefetch(compile_wave(PlanSpec(L=L, M=M), M))
    assert base.count(Op.PREFETCH_ACT) == 0


# ---------------------------------------------------------------------------
# the sweep: three-way cross-check + bitwise policy parity
# ---------------------------------------------------------------------------

SWEEP = [
    # (sched, M, W, alpha)
    ("vertical", 1, 0, 0.0),
    ("vertical", 2, 0, 0.5),
    ("vertical", 4, 0, 0.0),
    ("horizontal", 1, 0, 0.0),
    ("horizontal", 2, 0, 0.0),
    ("horizontal", 4, 0, 0.5),
    ("wave", 2, 1, 0.0),
    ("wave", 4, 2, 0.5),
]


@pytest.mark.parametrize("sched,M,W,alpha", SWEEP)
def test_spill_three_way_crosscheck_and_bitwise(sched, M, W, alpha):
    """Spill's measured meters == plan_traffic == the closed forms, the
    recompute run still cross-checks, and the two policies' losses and
    final parameters are bitwise equal (f32)."""
    lr, mr, pr, params_r, _ = _run("recompute", sched, M, W, alpha)
    ls, ms_, ps, params_s, A = _run("spill", sched, M, W, alpha)
    assert all(np.isfinite(ls))
    assert lr == ls, "spill changed the losses"
    for a, b in zip(params_r, params_s):
        assert (a == b).all(), "spill changed the parameters"
    assert ms_ == ps, "spill measured != predicted"
    assert mr == pr, "recompute measured != predicted"
    Wr = {"vertical": M, "horizontal": 1}.get(sched, W)
    assert ps == _closed_form_spill(CFG.num_layers, params_s[0].size, M,
                                    Wr, A)


def test_spill_nonzero_ratios_crosscheck():
    """Partial host residency incl. an act head fraction: the analyzer's
    rounding matches the coordinator's exactly."""
    _, measured, pred, _, _ = _run(
        "spill", "vertical", 4,
        ratios=StorageRatios(0.5, 0.25, 0.5, act=0.3))
    assert measured == pred
    assert ("act", "cpu->ssd") in measured
    assert measured[("act", "cpu->ssd")] < measured[("act", "gpu->cpu")]


def test_act_fully_host_resident_never_touches_ssd():
    _, measured, pred, _, _ = _run(
        "spill", "vertical", 2, ratios=StorageRatios(0.0, 0.0, 0.0,
                                                     act=1.0))
    assert measured == pred
    assert ("act", "cpu->ssd") not in measured
    assert ("act", "ssd->cpu") not in measured


def test_act_nbytes_counts_distinct_saved_tensors():
    """The payload is every distinct tensor autograd saved for the layer's
    backward: the layer's weight views included (as the reference's vjp
    residuals hold every weight), each layer input once however many
    products it feeds, and every ``put`` has exactly that size."""
    with tempfile.TemporaryDirectory() as d:
        eng = OffloadEngine(CFG, OffloadConfig(
            num_microbatches=2, micro_batch=MB, seq_len=S, ratios=X0,
            activation_policy="spill"), 7, d, device="cpu")
        P, A = eng.P, eng.act_nbytes
        p = torch.randn(P)
        x = torch.randn(MB, S, CFG.d_model)
        _, res = eng.j_layer_fwd_res(p, x)
        tensors = res.distinct()
        assert sum(t.numel() * t.element_size() for t in tensors) == A
        assert len(tensors) < len(res.saved)         # repeats deduped
        weights = [t for t in tensors
                   if t.untyped_storage().data_ptr()
                   == p.untyped_storage().data_ptr()]
        assert sum(t.numel() for t in weights) >= CFG.d_model * CFG.d_ff * 2
        assert A > 4 * P                             # weights + activations
        eng.close()


def test_spill_releases_device_storage_after_put():
    """After SPILL_ACT the graph holds no tensor storage: every saved slot
    is empty and the leaves' accumulate-grad nodes see empty tensors, so
    the layer's parameter buffer and input are not kept alive by the
    graph; ``get`` restores tensors of the same dtype, shape and stride."""
    with tempfile.TemporaryDirectory() as d:
        eng = OffloadEngine(CFG, OffloadConfig(
            num_microbatches=2, micro_batch=MB, seq_len=S, ratios=X0,
            activation_policy="spill"), 7, d, device="cpu")
        p = torch.randn(eng.P)
        x = torch.randn(MB, S, CFG.d_model)
        _, res = eng.j_layer_fwd_res(p, x)
        before = [(t.dtype, tuple(t.shape), t.stride(), t.clone())
                  for t in res.distinct()]
        eng.act_c.put(0, 0, res)
        assert all(t is None for t in res.saved)
        for edge in res.in_edges:
            assert edge.node.variable.numel() == 0
        back = eng.act_c.get(0, 0)
        assert back is res
        for (dt, shp, st, val), t in zip(before, res.distinct()):
            assert (t.dtype, tuple(t.shape), t.stride()) == (dt, shp, st)
            assert torch.equal(t, val)
        eng.finish()
        eng.close()


# ---------------------------------------------------------------------------
# the port's spill engine against the reference's
# ---------------------------------------------------------------------------

GPT = get_config("gpt-tiny")
JGPT = jax_config("gpt-tiny")
LOSS_RTOL = {"float32": 1e-5, "bfloat16": 2e-4}   # test_torch_offload.py's


@pytest.mark.parametrize("schedule,W", [("vertical", 0), ("wave", 2)])
@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_spill_engine_matches_jax_spill_engine(schedule, W, param_dtype):
    """gpt-tiny, M 4 x 2 x 64, alpha 0.25, ratios (0.5, 0.5, 0.5, act
    0.5), both engines under ``activation_policy="spill"`` from the same
    state: losses within ``LOSS_RTOL``, every meter outside ``act`` equal
    to the reference's, the ``act`` meters equal to the port's
    ``plan_traffic`` x steps, and no fallback on either side."""
    M, mb, s = 4, 2, 64
    kw = dict(schedule=schedule, wave_size=W, alpha=0.25,
              param_dtype=param_dtype, num_microbatches=M, micro_batch=mb,
              seq_len=s, activation_policy="spill")
    data = SyntheticLM(GPT.vocab_size, seed=0)
    batches = [data.batch(M * mb, s) for _ in range(2)]
    with tempfile.TemporaryDirectory() as d:
        je = JaxOffloadEngine(JGPT, JaxOffloadConfig(
            ratios=JaxRatios(0.5, 0.5, 0.5, act=0.5), **kw),
            jax.random.PRNGKey(7), d)
        state = offload_state_from_jax(je)
        je.meter.reset()
        jl = [je.train_step(b) for b in batches]
        je.finish()
        jt = je.traffic()
        assert je.act_policy == "spill" and je.act_fallbacks == 0
        je.close()
    with tempfile.TemporaryDirectory() as d:
        te = OffloadEngine(GPT, OffloadConfig(
            ratios=StorageRatios(0.5, 0.5, 0.5, act=0.5), **kw), 0, d,
            params=state, device="cpu")
        tl = [te.train_step(b) for b in batches]
        te.finish()
        tt = te.traffic()
        pred = plan_traffic(te.plan, PlanCosts.from_engine(te))
        assert te.act_policy == "spill" and te.act_fallbacks == 0
        te.close()
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL[param_dtype])
    for t in (jt, tt):
        t.pop("host:peak_nbytes")
    assert ({k: v for k, v in tt.items() if not k.startswith("act:")}
            == {k: v for k, v in jt.items() if not k.startswith("act:")})
    act = {k: v for k, v in tt.items() if k.startswith("act:")}
    assert act == {f"{c}:{r}": 2 * v for (c, r), v in pred.items()
                   if c == "act"}
    assert set(act) == {k for k in jt if k.startswith("act:")}


# ---------------------------------------------------------------------------
# the auto policy
# ---------------------------------------------------------------------------

SLOW_GPU = MachineParams(gpu_flops=1e8, ssd_read_bw=50e9, ssd_write_bw=50e9,
                         pcie_bw=50e9, cpu_adam_bw=100e9)
FAST_GPU = MachineParams(gpu_flops=1e15, ssd_read_bw=0.5e9,
                         ssd_write_bw=0.25e9)


def _auto_engine_policy(machine):
    ocfg = OffloadConfig(schedule="vertical", num_microbatches=2,
                         micro_batch=MB, seq_len=S, ratios=X0,
                         activation_policy="auto", machine=machine)
    with tempfile.TemporaryDirectory() as d:
        eng = OffloadEngine(CFG, ocfg, 0, d, device="cpu")
        pol, n_spill = eng.act_policy, eng.plan.count(Op.SPILL_ACT)
        adaptive = eng.act_adaptive
        eng.close()
    return pol, n_spill, adaptive


def test_auto_policy_resolves_from_roofline():
    pol, n, adaptive = _auto_engine_policy(SLOW_GPU)
    assert pol == "spill" and n == CFG.num_layers * 2 and adaptive
    pol, n, adaptive = _auto_engine_policy(FAST_GPU)
    assert pol == "recompute" and n == 0 and not adaptive


def test_pick_activation_policy_directions():
    w = Workload(ms=2e9, cs=0.1e9, os_bytes=12e9, grad_bytes=4e9,
                 flops_per_mb=2e12, tokens_per_mb=4096, n_layers=8,
                 as_bytes=0.2e9)
    assert pick_activation_policy(w, SLOW_GPU, 8, 8, 0.0, X0) == "spill"
    assert pick_activation_policy(w, FAST_GPU, 8, 8, 0.0, X0) == "recompute"
    t_re = iteration_time_vertical(w, SLOW_GPU, 8, 0.0, X0)
    t_sp = iteration_time_vertical(w, SLOW_GPU, 8, 0.0, X0, act="spill")
    assert t_sp < t_re


WORKLOADS = [
    dict(ms=2e9, cs=0.1e9, os_bytes=12e9, grad_bytes=4e9, flops_per_mb=2e12,
         tokens_per_mb=4096, n_layers=8, as_bytes=0.2e9),
    dict(ms=3.2e9, cs=3.4e7, os_bytes=1.9e10, grad_bytes=6.4e9,
         flops_per_mb=4.5e13, tokens_per_mb=2048, n_layers=2,
         as_bytes=1.1e10),
    dict(ms=6.3e6, cs=2.6e5, os_bytes=3.8e7, grad_bytes=1.3e7,
         flops_per_mb=1.6e10, tokens_per_mb=128, n_layers=4,
         as_bytes=2.2e7),
]
MACHINES = [dict(), dict(gpu_flops=1e8, ssd_read_bw=50e9, ssd_write_bw=50e9,
                         pcie_bw=50e9, cpu_adam_bw=100e9),
            dict(gpu_flops=1e15, ssd_read_bw=0.5e9, ssd_write_bw=0.25e9),
            dict(gpu_flops=4e14, ssd_read_bw=6e9, ssd_write_bw=3e9,
                 pcie_bw=25e9)]


@pytest.mark.parametrize("wi", range(len(WORKLOADS)))
@pytest.mark.parametrize("mi", range(len(MACHINES)))
@pytest.mark.parametrize("M,W,alpha,lookahead", [(4, 4, 0.0, True),
                                                  (8, 2, 0.25, False)])
def test_auto_picks_what_the_reference_picks(wi, mi, M, W, alpha,
                                             lookahead):
    """The port's ``pick_activation_policy`` (which ``"auto"`` calls)
    against the reference's on the same workload, machine, schedule and
    ratios."""
    x = dict(ckpt=0.5, param=0.5, opt=0.5, act=0.5)
    got = pick_activation_policy(Workload(**WORKLOADS[wi]),
                                 MachineParams(**MACHINES[mi]), M, W, alpha,
                                 StorageRatios(**x), lookahead=lookahead)
    want = jax_pick_activation_policy(
        JaxWorkload(**WORKLOADS[wi]), JaxMachine(**MACHINES[mi]), M, W,
        alpha, JaxRatios(**x), lookahead=lookahead)
    assert got == want


def test_resolve_auto_matches_the_reference_engine():
    """``resolve_activation_policy`` on the reference engine's own sizes
    (its P, dtype and residual payload) resolves as the reference engine
    did, on both machine regimes."""
    for machine in (SLOW_GPU, FAST_GPU):
        jm = JaxMachine(**dataclasses.asdict(machine))
        with tempfile.TemporaryDirectory() as d:
            je = JaxOffloadEngine(jax_config("gpt-tiny"), JaxOffloadConfig(
                num_microbatches=2, micro_batch=1, seq_len=16,
                activation_policy="auto", machine=jm),
                jax.random.PRNGKey(0), d)
            want, P, A = je.act_policy, je.P, je.act_nbytes
            je.close()
        got = resolve_activation_policy(
            OffloadConfig(num_microbatches=2, micro_batch=1, seq_len=16,
                          activation_policy="auto", machine=machine),
            GPT, P, 4, A)
        assert got == want


def test_unknown_engine_policy_rejected():
    with pytest.raises(ValueError, match="activation_policy"):
        OffloadConfig(schedule="vertical", num_microbatches=2,
                      micro_batch=MB, seq_len=S, activation_policy="nope")


# ---------------------------------------------------------------------------
# coordinator unit: byte-exact round trip
# ---------------------------------------------------------------------------

def test_act_coordinator_roundtrip(tmp_path):
    """Mixed dtypes (bf16 included), a 0-d scalar, a transposed view and a
    repeated entry: every tensor comes back bitwise with its dtype, shape
    and stride, nothing stays tracked, and the meters count the payload's
    bytes, the tail on the SSD routes."""
    meter = TrafficMeter()
    ioe = IOEngine(IOConfig(paths=[str(tmp_path / "p")]), meter=meter)
    ssd = SSDStore(ioe.paths[0], meter, engine=ioe)
    host = HostStore(meter)
    co = ActivationCoordinator(0.25, host, ssd, meter, ioe)
    a = torch.arange(37, dtype=torch.float32)
    w = torch.randn(5, 3)
    saved = [a, torch.tensor(5, dtype=torch.int32), w.t(),
             torch.randn(4, 6).to(torch.bfloat16), a,
             torch.tensor(2.5)]
    res = LayerResiduals(list(saved))
    want = [t.clone() for t in saved]
    nbytes = res.nbytes()
    assert nbytes == sum(t.numel() * t.element_size()
                         for i, t in enumerate(saved) if i != 4)
    co.put(1, 0, res)
    co.prefetch(1, 0)
    got = co.get(1, 0)
    for t, w0, orig in zip(got.saved, want, saved):
        assert t.dtype == w0.dtype and t.shape == w0.shape
        assert t.stride() == orig.stride()
        assert torch.equal(t, w0)
    assert got.saved[0] is got.saved[4]
    assert co._n == {} and co._pending == {} and co._prefetched == {}
    assert host.nbytes() == 0
    assert meter.bytes[("act", "gpu->cpu")] == nbytes
    assert meter.bytes[("act", "cpu->gpu")] == nbytes
    tail = nbytes - int(round(0.25 * nbytes))
    assert meter.bytes[("act", "cpu->ssd")] == tail
    assert meter.bytes[("act", "ssd->cpu")] == tail
    co.nbytes = nbytes + 1
    with pytest.raises(RuntimeError, match="act payload"):
        co.put(1, 1, LayerResiduals([torch.zeros(3)]))
    ssd.close()
    ioe.shutdown(wait=True)


# ---------------------------------------------------------------------------
# faults (tests/test_act_faults.py's battery)
# ---------------------------------------------------------------------------

FM = 4


def _spill_engine(d, chaos=True):
    eng = OffloadEngine(CFG, OffloadConfig(
        schedule="vertical", num_microbatches=FM, micro_batch=MB,
        seq_len=S, ratios=X0, activation_policy="spill"), 3, d,
        device="cpu")
    if chaos:
        install_chaos(eng.ssd)                # init writes stay intact
    return eng


def _clean_losses(steps=2):
    """Losses of a fault-free spill engine (bitwise equal to the
    recompute engine's by the executor's construction)."""
    with tempfile.TemporaryDirectory() as d:
        eng = _spill_engine(d, chaos=False)
        data = SyntheticLM(CFG.vocab_size, seed=0)
        losses = [eng.train_step(data.batch(FM * MB, S))
                  for _ in range(steps)]
        eng.finish()
        eng.close()
    return losses


def _assert_act_clean(eng):
    co = eng.act_c
    assert co._pending == {}, "leaked in-flight act spills"
    assert co._prefetched == {}, "leaked act prefetch reads"
    assert co._n == {} and co._meta == {} and co._res == {}, \
        "leaked act tracking state"
    assert eng.host.nbytes() == 0, "leaked host buffers"


def test_act_write_fault_degrades_to_recompute_bitwise():
    ref = _clean_losses()
    with tempfile.TemporaryDirectory() as d:
        eng = _spill_engine(d)
        data = SyntheticLM(CFG.vocab_size, seed=0)
        eng.ssd.files.fail_name_writes["act:"] = 1
        losses = [eng.train_step(data.batch(FM * MB, S)) for _ in range(2)]
        assert eng.act_fallbacks == 1
        assert losses == ref, "fallback changed the arithmetic"
        eng.finish()
        _assert_act_clean(eng)
        s = eng.ioe.metrics_snapshot()
        assert s["inflight_bytes"] == 0, "fault leaked the byte budget"
        assert s["completed"] + s["cancelled"] == s["submitted"]
        eng.close()


def test_act_read_fault_degrades_to_recompute_bitwise():
    ref = _clean_losses()
    with tempfile.TemporaryDirectory() as d:
        eng = _spill_engine(d)
        data = SyntheticLM(CFG.vocab_size, seed=0)
        eng.train_step(data.batch(FM * MB, S))     # step 1 clean
        eng.ssd.files.fail_name_reads["act:"] = 1
        losses = [ref[0], eng.train_step(data.batch(FM * MB, S))]
        assert eng.act_fallbacks >= 1
        assert losses == ref
        eng.finish()
        _assert_act_clean(eng)
        assert eng.ioe.metrics_snapshot()["inflight_bytes"] == 0
        eng.close()


def test_act_fault_releases_staging_buffers():
    with tempfile.TemporaryDirectory() as d:
        eng = _spill_engine(d)
        data = SyntheticLM(CFG.vocab_size, seed=0)
        eng.ssd.files.fail_name_writes["act:"] = 2
        eng.train_step(data.batch(FM * MB, S))
        eng.finish()
        nbuf = eng.ioe.config.staging_buffers
        got = threading.Event()

        def drain_pool():
            bufs = [eng.ioe.staging.acquire(64) for _ in range(nbuf)]
            got.set()
            for b in bufs:
                b.release()

        t = threading.Thread(target=drain_pool, daemon=True)
        t.start()
        assert got.wait(5.0), "failed act spill leaked a staging buffer"
        t.join(5.0)
        eng.close()


def test_non_act_fault_clears_act_coordinator():
    """A checkpoint-spill write fault on the head boundary surfaces before
    any FETCH_ACT, with every act payload still tracked: the executor's
    cleanup clears the activation coordinator too, and the next step runs
    clean and without fallbacks."""
    with tempfile.TemporaryDirectory() as d:
        eng = _spill_engine(d)
        data = SyntheticLM(CFG.vocab_size, seed=0)
        eng.ssd.files.fail_prefix = f"c:{CFG.num_layers}:"
        with pytest.raises(OSError, match="injected write fault"):
            eng.train_step(data.batch(FM * MB, S))
        _assert_act_clean(eng)
        assert eng.ckpt_c._device_kept == {}
        assert eng.params_c._futures == {}
        before = eng.act_fallbacks
        loss = eng.train_step(data.batch(FM * MB, S))
        assert np.isfinite(loss)
        assert eng.act_fallbacks == before, "recovered step degraded"
        eng.finish()
        _assert_act_clean(eng)
        eng.close()


def test_adaptive_spill_skips_degrade_bitwise(monkeypatch):
    """``"auto"`` resolved to spill skips a spill while the write queue is
    saturated (``act_skips``); its FETCH_ACT falls back to recompute and
    the losses stay bitwise those of a clean run."""
    import repro_torch.offload.executor as ex
    ref = _clean_losses()
    with tempfile.TemporaryDirectory() as d:
        eng = OffloadEngine(CFG, OffloadConfig(
            schedule="vertical", num_microbatches=FM, micro_batch=MB,
            seq_len=S, ratios=X0, activation_policy="auto",
            machine=SLOW_GPU), 3, d, device="cpu")
        assert eng.act_policy == "spill" and eng.act_adaptive
        calls = []
        real = ex._saturated

        def saturated(ioe, frac, route):
            if route == "cpu->ssd":
                calls.append(route)
                return len(calls) == 1      # the first spill is skipped
            return real(ioe, frac, route)
        monkeypatch.setattr(ex, "_saturated", saturated)
        data = SyntheticLM(CFG.vocab_size, seed=0)
        losses = [eng.train_step(data.batch(FM * MB, S)) for _ in range(2)]
        assert eng.act_skips == 1 and eng.act_fallbacks == 1
        assert losses == ref
        eng.finish()
        _assert_act_clean(eng)
        eng.close()
