"""The port's spans and counters of the host work inside a training step
(``repro_torch.obs.tracer``, the executor, the coordinators), on the CPU
at starcoder2-7b's SMOKE size, vertical and wave plans at α 0.25, half of
every tier on the SSD:

* the ``copy.*`` spans' bytes, summed by (category, direction), equal the
  ``TrafficMeter``'s ``gpu->cpu`` / ``cpu->gpu`` bytes;
* the ``adam.update`` spans' elements sum to L x P a step, the early and
  the late segments together, and the always-on counters agree;
* every ``opt.wait`` span names an ``io.req`` span's request;
* ``eng.host_syncs`` is M + 1 a step (a ``float(loss)`` a micro-batch and
  the ``BARRIER``), one ``sync`` span each;
* no new span lands on the executor's ``exec`` track, whose plan-op spans
  stay disjoint;
* with the tracer off a step records no span and the counters count;
* on the card (``-m gpu``) each pageable copy's span starts after a
  ``copy.wait`` span in which the stream drained, so it holds the copy
  and not the work queued before it; the inter-layer gradients go
  through the pinned pool (``pinned`` true) and drain nothing, and the
  checkpoints, which have an SSD tail at this ratio, stay pageable;
* the clock mapping puts a ``torch.profiler`` range inside the tracer
  span that holds it, and ``export_chrome`` writes on the profiler's
  Chrome-trace base.
"""
import json
import tempfile
import time
from collections import defaultdict

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_smoke
from repro_torch.core.perfmodel import StorageRatios
from repro_torch.data import SyntheticLM
from repro_torch.io import IOConfig
from repro_torch.obs import tracer as tracer_mod
from repro_torch.obs.tracer import HOST_TRACK, Tracer
from repro_torch.offload import OffloadConfig, OffloadEngine
from repro_torch.offload.executor import EXEC_TRACK
from repro_torch.optim.cpu_adam import pool_width

CFG = get_smoke("starcoder2-7b")
M, MB, S = 4, 1, 32
NEW_CATS = {"copy", "sync", "opt"}
#: (schedule, wave size, activation policy): the vertical plan, the
#: wave plan's f32 gradient buffer copies, the activation stream's copies
PLANS = [("vertical", 0, "recompute"), ("wave", 2, "recompute"),
         ("vertical", 0, "spill")]


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _engine(d, plan, trace=True, device="cpu"):
    sched, wave, act = plan
    ocfg = OffloadConfig(schedule=sched, num_microbatches=M, micro_batch=MB,
                         seq_len=S, alpha=0.25, wave_size=wave,
                         ratios=StorageRatios(0.5, 0.5, 0.5, act=0.5),
                         activation_policy=act, prefetch_depth=1,
                         trace=trace,
                         io=IOConfig(paths=[d], chunk_bytes=1 << 16))
    return OffloadEngine(CFG, ocfg, 0, d, device=device)


def _batch(k):
    return SyntheticLM(CFG.vocab_size, seed=k).batch(M * MB, S)


_RUNS = {}


def _traced(plan):
    """One traced step from a fresh engine, and its ``finish()``: the
    spans, the meters and the counters (cached per plan)."""
    if plan not in _RUNS:
        with tempfile.TemporaryDirectory() as d:
            eng = _engine(d, plan)
            try:
                eng.train_step(_batch(1))
                eng.finish()
                _RUNS[plan] = dict(
                    spans=eng.tracer.spans(), dropped=eng.tracer.dropped,
                    meter=dict(eng.meter.snapshot()),
                    snap=eng.metrics_snapshot(), L=eng.L, P=eng.P)
            finally:
                eng.close()
    return _RUNS[plan]


def _named(spans, *names):
    return [s for s in spans if s[1] in names and s[4] is not None]


@pytest.mark.parametrize("plan", PLANS, ids=["-".join(map(str, p))
                                             for p in PLANS])
def test_copy_bytes_equal_the_meters(plan):
    run = _traced(plan)
    assert run["dropped"] == 0
    spans = defaultdict(int)
    for s in _named(run["spans"], "copy.d2h", "copy.h2d"):
        a = s[5]
        assert s[2] == "copy" and s[0] == HOST_TRACK and a["pinned"] is False
        route = "gpu->cpu" if s[1] == "copy.d2h" else "cpu->gpu"
        spans[f"{a['category']}:{route}"] += a["nbytes"]
    metered = {k: v for k, v in run["meter"].items()
               if k.endswith(":gpu->cpu") or k.endswith(":cpu->gpu")}
    # the token and label copies are the only unmetered ones
    extra = {k: spans.pop(k) for k in list(spans)
             if k.split(":")[0] in ("tokens", "labels")}
    assert set(extra) == {"tokens:cpu->gpu", "labels:cpu->gpu"}
    # the embedding's forward and backward each copy the int64 ids
    assert extra["tokens:cpu->gpu"] == 2 * M * MB * S * 8
    assert spans == metered
    if plan[2] == "spill":
        assert metered["act:gpu->cpu"] > 0
    if plan[0] == "wave":
        assert metered["grad:cpu->gpu"] > 0
    stages = _named(run["spans"], "host.stage")
    assert {s[5]["what"] for s in stages} >= {"put_ckpt", "get_ckpt_fwd"}
    assert all(s[0] == HOST_TRACK and s[2] == "copy" for s in stages)


@pytest.mark.parametrize("plan", PLANS[:2], ids=["vertical", "wave"])
def test_adam_updates_cover_every_layer_once(plan):
    run = _traced(plan)
    ups = _named(run["spans"], "adam.update")
    by_layer = defaultdict(int)
    for s in ups:
        assert s[2] == "opt" and s[0] != HOST_TRACK       # on a worker
        assert s[5]["step"] == 1 and s[5]["req"] >= 0
        assert 1 <= s[5]["threads"] <= pool_width()
        by_layer[s[5]["l"]] += s[5]["params"]
    assert {s[5]["seg"] for s in ups} == {"early", "late"}
    assert dict(by_layer) == {l: run["P"] for l in range(run["L"])}
    assert sum(by_layer.values()) == run["L"] * run["P"]
    adam = run["snap"]["counters"]["adam"][0]
    assert adam["calls"] == len(ups)
    assert adam["params"] == run["L"] * run["P"]
    assert adam["busy_s"] == pytest.approx(sum(s[4] - s[3] for s in ups))
    assert run["snap"]["counters"]["adam_threads"] == pool_width()


@pytest.mark.parametrize("plan", PLANS[:2], ids=["vertical", "wave"])
def test_every_opt_wait_names_a_request(plan):
    run = _traced(plan)
    reqs = {s[5]["req"] for s in run["spans"] if s[2] == "io.req"}
    waits = _named(run["spans"], "opt.wait")
    assert {s[5]["kind"] for s in waits} >= {"early", "late"}
    for s in waits:
        assert s[2] == "opt" and s[5]["req"] in reqs, s
    # the α-tail flush waits on the layer's early update on the executor
    assert any(s[5]["kind"] == "early" and s[0] == HOST_TRACK
               for s in waits)
    chunks = [s for s in run["spans"] if s[2] == "io.chunk"]
    assert chunks and all(isinstance(s[5]["req"], int) for s in chunks)


def test_host_syncs_are_m_plus_one_a_step():
    with tempfile.TemporaryDirectory() as d:
        eng = _engine(d, PLANS[0])
        try:
            for k in (1, 2):
                eng.train_step(_batch(k))
                assert eng.host_syncs == k * (M + 1)
            syncs = _named(eng.tracer.spans(), "sync")
            assert len(syncs) == 2 * (M + 1)
            assert sum(s[5]["what"] == "barrier" for s in syncs) == 2
            assert all(s[0] == HOST_TRACK and s[2] == "sync" for s in syncs)
            assert eng.metrics_snapshot()["counters"]["host_syncs"] == \
                2 * (M + 1)
            eng.reset_stats()
            assert eng.host_syncs == 0 and eng.opt_c.adam_calls == 0
            assert eng.opt_c.adam_params == 0 and eng.opt_c.adam_busy_s == 0
        finally:
            eng.close()


@pytest.mark.parametrize("plan", PLANS, ids=["-".join(map(str, p))
                                             for p in PLANS])
def test_no_new_span_on_exec(plan):
    spans = _traced(plan)["spans"]
    on_exec = [s for s in spans if s[0] == EXEC_TRACK]
    assert on_exec and {s[2] for s in on_exec} <= {"plan", "hint"}
    new = [s for s in spans if s[2] in NEW_CATS]
    assert new and all(s[0] != EXEC_TRACK for s in new)
    assert not any(s[2] == "io.chunk" for s in new)
    ops = sorted((s[3], s[4]) for s in on_exec if s[4] is not None)
    assert all(b[0] >= a[1] for a, b in zip(ops, ops[1:]))
    # every executor-thread span sits inside one plan op's span
    for s in spans:
        if s[0] == HOST_TRACK and s[5].get("step") == 1 \
                and s[1] != "opt.wait":
            assert any(a <= s[3] and s[4] <= b for a, b in ops), s


def test_tracer_off_records_nothing_and_counters_count():
    with tempfile.TemporaryDirectory() as d:
        eng = _engine(d, PLANS[0], trace=False)
        try:
            eng.train_step(_batch(1))
            eng.finish()
            assert len(eng.tracer) == 0 and eng.tracer.dropped == 0
            assert eng.host_syncs == M + 1
            assert eng.opt_c.adam_params == eng.L * eng.P
            assert eng.opt_c.adam_calls == 2 * eng.L
            assert eng.opt_c.adam_busy_s > 0
        finally:
            eng.close()


@pytest.mark.gpu
@pytest.mark.skipif(not torch.cuda.is_available(), reason="needs a CUDA card")
def test_copies_on_the_card_start_after_the_stream_drains():
    with tempfile.TemporaryDirectory() as d:
        eng = _engine(d, PLANS[0], device="cuda")
        try:
            eng.train_step(_batch(1))
            eng.finish()
            spans = eng.tracer.spans()
            meter = dict(eng.meter.snapshot())
            assert eng.tracer.dropped == 0 and eng.host_syncs == M + 1
        finally:
            eng.close()
    waits = _named(spans, "copy.wait")
    copies = _named(spans, "copy.d2h", "copy.h2d")
    drains = [s for s in waits if s[5].get("what") != "pool"]
    pooled = [s for s in copies if s[5]["pinned"]]
    # at this engine's checkpoint ratio (0.5) only the inter-layer
    # gradients take a pool slot: a checkpoint with an SSD tail stays
    # pageable, since the plan holds only its head on the host
    pageable = {s[5]["category"] for s in copies if not s[5]["pinned"]}
    assert pooled and {s[5]["category"] for s in pooled} == {"inter_grad"}
    assert "ckpt" in pageable and "inter_grad" not in pageable
    assert len(drains) == len(copies) - len(pooled)
    assert all(s[0] == HOST_TRACK and s[2] == "sync" for s in waits)
    assert len(_named(spans, "sync")) == M + 1     # waits are not syncs
    host = sorted((s for s in spans if s[0] == HOST_TRACK and s[4]),
                  key=lambda s: s[3])
    for a, b in zip(host, host[1:]):
        if b[1] in ("copy.d2h", "copy.h2d") and not b[5]["pinned"]:
            assert a[1] == "copy.wait" and a[4] <= b[3], (a, b)
            assert (a[5]["l"], a[5]["m"]) == (b[5]["l"], b[5]["m"])
    got = defaultdict(int)
    for s in copies:
        if s[5]["category"] not in ("tokens", "labels"):
            route = "gpu->cpu" if s[1] == "copy.d2h" else "cpu->gpu"
            got[f"{s[5]['category']}:{route}"] += s[5]["nbytes"]
    assert dict(got) == {k: v for k, v in meter.items()
                         if k.endswith(("gpu->cpu", "cpu->gpu"))}


def test_profiler_range_maps_inside_its_span(tmp_path):
    from torch.profiler import ProfilerActivity, profile, record_function
    tr = Tracer()
    tr.enable()
    assert tracer_mod.last() is tr
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for i in range(3):
            t0 = time.perf_counter()
            with record_function(f"probe{i}"):
                time.sleep(0.005)
            tr.record("t", f"probe{i}", "test", t0, time.perf_counter())
    tr.disable()
    clock = tr.summary()["clock"]
    assert len(clock["anchors"]) == 2 and clock["drift_ns"] is not None
    mine = {s[1]: (tr.to_unix_ns(s[3]), tr.to_unix_ns(s[4]))
            for s in tr.spans()}
    theirs = {}
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith("probe"):
            theirs[e.name()] = (e.start_ns(), e.start_ns() + e.duration_ns())
    assert set(theirs) == set(mine)
    tol = 100_000                                  # 100 us
    for name, (a, b) in theirs.items():
        lo, hi = mine[name]
        assert lo - tol <= a and b <= hi + tol, (name, a - lo, hi - b)
    # both Chrome exports on one base: the same offsets, in us
    ours = tr.export_chrome(str(tmp_path / "tracer.json"))
    prof.export_chrome_trace(str(tmp_path / "prof.json"))
    doc = json.load(open(ours))
    pdoc = json.load(open(tmp_path / "prof.json"))
    if "baseTimeNanoseconds" in pdoc:
        assert doc["baseTimeNanoseconds"] == pdoc["baseTimeNanoseconds"]
    ev = {e["name"]: e for e in doc["traceEvents"] if e.get("ph") == "X"}
    pev = {e["name"]: e for e in pdoc["traceEvents"]
           if e.get("name", "").startswith("probe") and e.get("ph") == "X"}
    assert set(pev) == set(ev)
    for name, e in pev.items():
        lo, hi = ev[name]["ts"], ev[name]["ts"] + ev[name]["dur"]
        assert lo - 100 <= e["ts"] and e["ts"] + e["dur"] <= hi + 100
    # a stamp maps to the profiler's clock: Unix ns now
    assert abs(tr.to_unix_ns(time.perf_counter()) - time.time_ns()) < 5e6
    assert np.isfinite(clock["drift_ppm"])
