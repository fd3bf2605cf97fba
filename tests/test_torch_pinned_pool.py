"""The checkpoint coordinator's pinned pool (``offload.stores.PinnedPool``):
reused host slots for every checkpoint and inter-layer gradient payload.

On the CPU the pool is built directly with pageable slots (``pin=False``)
and attached to an engine's coordinator, which an engine on the CPU never
does by itself; the coordinator then runs the pooled path with
synchronous copies:

* the slots are carved out of ``pack``'s blocks and none spans two;
* the plan's live set (``plan_host_payloads``) is the most slots a step
  holds at once, in vertical and wave plans, and a slot is held only
  while the host store counts its payload's whole bytes;
* slots are reused across steps, and none is held after a step, after
  ``clear()`` or after a mid-step failure's unwind;
* a pool too small for the live set sends the rest down the pageable
  path and counts them in ``pool_fallbacks``;
* the pooled engine equals the pageable one bitwise over two steps
  (losses, parameters, masters, moments, head), with every
  ``TrafficMeter`` byte, ``HostStore.nbytes()`` and ``peak_nbytes``
  equal; data-parallel ranks with a pool each too;
* at a checkpoint ratio of 0.5 a checkpoint stays pageable (its SSD
  tail holds the payload's tail, the backward gets the whole payload
  back) while its inter-layer gradient takes a slot;
* a pooled copy's span says ``pinned`` and carries the metered bytes.

On the card (``-m gpu``): the engine's own slots are pinned, a
device-to-host copy into a slot returns before the copy has run, a
source freed right after its ``put_ckpt`` and overwritten by a later
kernel still comes back with its own bytes, checkpoints and
gradients come back bitwise equal to the pageable path's, and a plan
swap rebuilds the pool only when the live set changes.
"""
import os
import tempfile
from collections import Counter, defaultdict

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_smoke
from repro_torch.core.perfmodel import StorageRatios
from repro_torch.core.plan import PlanCosts, plan_host_payloads
from repro_torch.data import SyntheticLM
from repro_torch.io import IOConfig
from repro_torch.offload import (DataParallelOffloadEngine, OffloadConfig,
                                 OffloadEngine, pack)
from repro_torch.offload.stores import PinnedPool

CFG = get_smoke("starcoder2-7b")
M, MB, S = 4, 1, 32
SIZE = MB * S * CFG.d_model * 4          # one f32 boundary tensor
#: (schedule, wave size, checkpoint ratio)
PLANS = [("vertical", 0, 1.0), ("wave", 2, 1.0), ("vertical", 0, 0.5),
         ("horizontal", 0, 0.0)]
IDS = ["-".join(map(str, p)) for p in PLANS]


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ocfg(plan, trace=False, device="cpu"):
    sched, wave, x_ckpt = plan
    return OffloadConfig(schedule=sched, num_microbatches=M, micro_batch=MB,
                         seq_len=S, alpha=0.25, wave_size=wave,
                         ratios=StorageRatios(x_ckpt, 0.5, 0.5),
                         prefetch_depth=1, trace=trace,
                         io=IOConfig(chunk_bytes=1 << 16))


def _engine(d, plan, trace=False, device="cpu", ranks=1):
    ocfg = _ocfg(plan, trace)
    if ranks > 1:
        return DataParallelOffloadEngine(CFG, ocfg, 0, d, ranks=ranks,
                                         device=device)
    return OffloadEngine(CFG, ocfg, 0, d, device=device)


def _stacks(eng):
    return list(getattr(eng, "ranks", [eng]))


def _attach(eng, n=None):
    """A pageable pool on each rank stack, sized by that rank's plan
    (or ``n`` slots); returns the pools."""
    want = _live(eng)
    pools = []
    for st, k in zip(_stacks(eng), want):
        pools.append(PinnedPool(k if n is None else n, SIZE, pin=False))
        st.ckpt_c.attach_pool(pools[-1])
    return pools


def _live(eng):
    return plan_host_payloads(eng.plan, PlanCosts.from_engine(eng))


def _batch(k):
    return SyntheticLM(CFG.vocab_size, seed=k).batch(M * MB, S)


def _state(eng):
    out = {}
    for r, st in enumerate(_stacks(eng)):
        for attr in ("p_vecs", "m_master", "m_m", "m_v"):
            for l, v in enumerate(getattr(st, attr)):
                out[(r, attr, l)] = v.read().copy()
    for name in ("embed", "unembed", "final_norm"):
        out[name] = getattr(eng, name).detach().float().numpy().copy()
    return out


def _run(plan, pooled, n=None, steps=2, ranks=1, trace=False):
    """``steps`` steps from the seed's state; what they left."""
    with tempfile.TemporaryDirectory() as d:
        eng = _engine(d, plan, trace=trace, ranks=ranks)
        try:
            pools = _attach(eng, n) if pooled else []
            losses = []
            for k in range(1, steps + 1):
                losses.append(eng.train_step(_batch(k)))
                for p in pools:
                    assert p.free() == p.nslots, "a slot outlived its step"
            eng.finish()
            return dict(
                losses=losses, state=_state(eng),
                meter=[dict(st.meter.snapshot()) for st in _stacks(eng)],
                host=[(st.host.nbytes(), st.host.peak_nbytes)
                      for st in _stacks(eng)],
                counters=eng.metrics_snapshot()["counters"],
                spans=eng.tracer.spans() if trace else [],
                pools=pools)
        finally:
            eng.close()


_PAGEABLE = {}


def _pageable(plan, ranks=1):
    if (plan, ranks) not in _PAGEABLE:
        _PAGEABLE[(plan, ranks)] = _run(plan, False, ranks=ranks)
    return _PAGEABLE[(plan, ranks)]


def _assert_same(a, b):
    assert a["losses"] == b["losses"]
    assert a["state"].keys() == b["state"].keys()
    for k in a["state"]:
        assert np.array_equal(a["state"][k], b["state"][k]), k
    assert a["meter"] == b["meter"]
    assert a["host"] == b["host"]


# the cells' payload counts at 1/1024 of their sizes (18 / 40 MiB
# there): the same blocks, scaled, without pinning gigabytes here
@pytest.mark.parametrize("n,size", [(577, 18 << 10), (193, 40 << 10),
                                    (13, SIZE), (1, 3), (7, 1000)])
def test_slots_come_from_pack(n, size):
    pool = PinnedPool(n, size, pin=False)
    total, blocks = pack(n, size)
    assert [b.numel() for b in pool.blocks] == blocks
    assert pool.nbytes == total and pool.n == n and not pool.pinned
    assert pool.nslots == sum(b // size for b in blocks) >= n
    spans = [(b.data_ptr(), b.data_ptr() + b.numel()) for b in pool.blocks]
    slots = [pool.acquire() for _ in range(pool.nslots)]
    assert pool.acquire() is None and pool.free() == 0
    seen = set()
    for s in slots:
        lo = s.t.data_ptr()
        assert s.t.numel() == size and s.t.dtype == torch.uint8
        assert sum(a <= lo and lo + size <= b for a, b in spans) == 1
        assert lo not in seen
        seen.add(lo)
    for s in slots:
        pool.release(s)
    assert pool.free() == pool.nslots
    # the oldest released slot comes back first
    assert pool.acquire() is slots[0]


def test_budget_caps_the_pinned_bytes():
    size = 18 << 10
    pool = PinnedPool(577, size, pin=False, budget=3 << 20)
    assert pool.asked == 577 and 0 < pool.n < 577
    assert pool.nbytes == pack(pool.n, size)[0] <= 3 << 20
    assert pack(pool.n + 1, size)[0] > 3 << 20
    assert PinnedPool(5, size, pin=False, budget=size - 1).nslots == 0


@pytest.mark.parametrize("plan", PLANS[:3], ids=IDS[:3])
def test_live_set_is_the_most_slots_held(plan):
    with tempfile.TemporaryDirectory() as d:
        eng = _engine(d, plan)
        try:
            (pool,) = _attach(eng)
            held, acquired = [0], Counter()
            take = pool.acquire

            def acquire():
                # every slot held has its payload's whole bytes counted
                # by the host store: the pool pins no more than the
                # plan holds on the host
                for kind, l, m in eng.ckpt_c._slots:
                    name = f"{kind}:{l}:{m}" + (":h" if kind == "c" else "")
                    assert eng.host.get(name).nbytes == SIZE
                s = take()
                acquired[id(s)] += 1
                held.append(pool.nslots - pool.free())
                return s
            pool.acquire = acquire
            eng.train_step(_batch(1))
            eng.train_step(_batch(2))
            eng.finish()
            want = _live(eng)[0]
            # vertical: M + 1 gradients and 2 M checkpoints; a checkpoint
            # with an SSD tail takes no slot
            assert want == {PLANS[0]: 3 * M + 1, PLANS[1]: 7,
                            PLANS[2]: M}[plan]
            assert max(held) == want
            # the slots are taken again and again, none left out
            assert len(acquired) == pool.nslots >= want
            assert min(acquired.values()) >= 2
            assert eng.ckpt_c.pool_fallbacks == 0
        finally:
            eng.close()


@pytest.mark.parametrize("plan", PLANS, ids=IDS)
def test_pooled_engine_equals_pageable(plan):
    got = _run(plan, True)
    _assert_same(got, _pageable(plan))
    c = got["counters"]
    # horizontal at ratio 0 holds no payload whole on the host: no slot
    live = got["pools"][0].asked
    assert live == 0 if plan == PLANS[3] else live > 0
    assert c["pool_fallbacks"] == 0 and (c["pool_copies"] > 0) == (live > 0)
    assert c["pool_slots"] == got["pools"][0].nslots
    assert c["pool_pinned_bytes"] == 0          # pageable slots


def test_full_pool_falls_back_to_pageable():
    plan = PLANS[0]
    got = _run(plan, True, n=2)
    _assert_same(got, _pageable(plan))
    c = got["counters"]
    assert c["pool_slots"] == 2
    assert c["pool_fallbacks"] > 0 and c["pool_copies"] > 0


def test_data_parallel_ranks_pool_each():
    plan = PLANS[0]
    got = _run(plan, True, ranks=2)
    _assert_same(got, _pageable(plan, ranks=2))
    assert [p.n for p in got["pools"]] == [3 * M // 2 + 1] * 2
    assert got["counters"]["pool_fallbacks"] == 0


def test_pooled_copies_carry_pinned_spans():
    got = _run(PLANS[0], True, steps=1, trace=True)
    by = defaultdict(int)
    for s in got["spans"]:
        if s[1] in ("copy.d2h", "copy.h2d") and s[4] is not None:
            a = s[5]
            assert a["pinned"] is (a["category"] in ("ckpt", "inter_grad"))
            route = "gpu->cpu" if s[1] == "copy.d2h" else "cpu->gpu"
            by[f"{a['category']}:{route}"] += a["nbytes"]
    meter = got["meter"][0]
    for k in ("ckpt:gpu->cpu", "ckpt:cpu->gpu", "inter_grad:gpu->cpu",
              "inter_grad:cpu->gpu"):
        assert by[k] == meter[k] > 0
    # ratio 1.0: no host staging, and the CPU has no copy to wait on
    assert not [s for s in got["spans"]
                if s[1] in ("host.stage", "copy.wait")]


def test_reset_stats_zeroes_the_pool_counts():
    with tempfile.TemporaryDirectory() as d:
        eng = _engine(d, PLANS[0])
        try:
            (pool,) = _attach(eng)
            eng.train_step(_batch(1))
            assert eng.ckpt_c.pool_copies > 0
            eng.reset_stats()
            c = eng.metrics_snapshot()["counters"]
            assert c["pool_copies"] == c["pool_fallbacks"] == 0
            assert c["pool_slots"] == pool.nslots
        finally:
            eng.close()


def test_clear_returns_every_slot():
    with tempfile.TemporaryDirectory() as d:
        eng = _engine(d, PLANS[0])
        try:
            (pool,) = _attach(eng)
            c = eng.ckpt_c
            before = eng.host.nbytes()
            y = torch.randn(MB, S, CFG.d_model)
            c.put_ckpt(0, 0, y)
            c.put_ckpt(1, 0, y, keep_on_device=True)
            c.put_grad(1, 0, y)
            assert pool.free() == pool.nslots - 3
            assert eng.host.nbytes() == before + 3 * SIZE
            with pytest.raises(RuntimeError):
                c.attach_pool(None)             # slots still held
            c.clear()
            assert pool.free() == pool.nslots and not c._slots
            assert eng.host.nbytes() == before
            c.attach_pool(None)
        finally:
            eng.close()


@pytest.mark.parametrize("plan", PLANS[:3], ids=IDS[:3])
def test_failed_step_returns_every_slot(plan):
    with tempfile.TemporaryDirectory() as d:
        eng = _engine(d, plan)
        try:
            (pool,) = _attach(eng)
            bwd, calls = eng.j_layer_bwd_res, [0]

            def faulty(res, dy):
                calls[0] += 1
                if calls[0] == 3:
                    raise RuntimeError("injected backward fault")
                return bwd(res, dy)
            eng.j_layer_bwd_res = faulty
            with pytest.raises(RuntimeError, match="injected"):
                eng.train_step(_batch(1))
            assert pool.free() == pool.nslots and not eng.ckpt_c._slots
            eng.j_layer_bwd_res = bwd
            eng.train_step(_batch(2))         # the engine runs on
            assert pool.free() == pool.nslots
            eng.finish()
        finally:
            eng.close()


def test_half_ratio_tail_reaches_the_ssd():
    with tempfile.TemporaryDirectory() as d:
        eng = _engine(d, PLANS[2])
        try:
            (pool,) = _attach(eng)
            c = eng.ckpt_c
            y = torch.randn(MB, S, CFG.d_model)
            c.put_ckpt(3, 1, y)
            # a tail on the SSD: the checkpoint stays pageable
            assert ("c", 3, 1) not in c._slots and pool.free() == pool.nslots
            c.put_grad(3, 1, 2 * y)
            assert ("g", 3, 1) in c._slots
            c.wait_pending()
            flat = y.reshape(-1).numpy()
            k = int(round(0.5 * flat.size))
            assert np.array_equal(eng.ssd.read("c:3:1:s", "ckpt"), flat[k:])
            assert np.array_equal(eng.host.get("c:3:1:h"), flat[:k])
            assert eng.host.get("c:3:1:tail").size == flat.size - k
            assert torch.equal(c.get_ckpt_fwd(3, 1), y)
            assert "c:3:1:tail" not in eng.host
            # the host holds the head alone: the backward reads the SSD's
            assert torch.equal(c.get_ckpt_bwd(3, 1), y)
            assert torch.equal(c.get_grad(3, 1), 2 * y)
            c.drop_ckpt(3, 1)
            assert pool.free() == pool.nslots and c.pool_fallbacks == 0
        finally:
            eng.close()


# ---- on the card ----

gpu = pytest.mark.gpu


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _card_engine(d, plan=PLANS[0]):
    return OffloadEngine(CFG, _ocfg(plan), 0, d, device=_card())


@gpu
def test_card_engine_builds_pinned_slots():
    with tempfile.TemporaryDirectory() as d:
        eng = _card_engine(d)
        try:
            pool = eng.ckpt_c.pool
            assert pool is not None and pool.pinned
            assert pool.asked == _live(eng)[0]
            assert all(b.is_pinned() for b in pool.blocks)
            c = eng.metrics_snapshot()["counters"]
            assert c["pool_pinned_bytes"] == pool.nbytes \
                == pack(pool.n, pool.size)[0]
        finally:
            eng.close()


@gpu
def test_d2h_into_a_slot_returns_before_the_copy_runs():
    with tempfile.TemporaryDirectory() as d:
        eng = _card_engine(d)
        try:
            c = eng.ckpt_c
            y = torch.randn(MB, S, CFG.d_model, device="cuda")
            torch.cuda.synchronize()
            torch.cuda._sleep(1 << 30)          # ~0.5 s of queued work
            c.put_ckpt(0, 0, y)
            slot = c._slots[("c", 0, 0)]
            assert not slot.d2h.query(), "put_ckpt waited for its copy"
            back = c.get_ckpt_fwd(0, 0)
            assert torch.equal(back, y)
            c.clear()
        finally:
            eng.close()


@gpu
def test_a_freed_source_keeps_its_bytes():
    """The copy stream reads the source after the compute stream has
    moved on: without ``record_stream`` the allocator would hand the
    source's storage to the next tensor, whose kernel overwrites it."""
    with tempfile.TemporaryDirectory() as d:
        eng = _card_engine(d)
        try:
            c = eng.ckpt_c
            n = MB * S * CFG.d_model
            want = []
            for m in range(M):
                y = torch.randn(MB, S, CFG.d_model, device="cuda")
                want.append(y.cpu())
                with torch.cuda.stream(c._d2h):
                    torch.cuda._sleep(1 << 27)  # the copy starts late
                c.put_ckpt(0, m, y)
                del y
                z = torch.empty(n, device="cuda")
                z.fill_(float("nan"))
                del z
            for m in range(M):
                assert torch.equal(c.get_ckpt_fwd(0, m).cpu(), want[m]), m
            c.clear()
        finally:
            eng.close()


@gpu
def test_card_pool_equals_pageable():
    _card()
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True)
    try:
        runs = []
        for pooled in (True, False):
            with tempfile.TemporaryDirectory() as d:
                eng = _card_engine(d)
                try:
                    if not pooled:
                        eng.ckpt_c.attach_pool(None)
                    losses = [eng.train_step(_batch(k)) for k in (1, 2)]
                    eng.finish()
                    c = eng.metrics_snapshot()["counters"]
                    assert (c["pool_copies"] > 0) is pooled
                    assert c["pool_fallbacks"] == 0
                    runs.append((losses, _state_card(eng),
                                 dict(eng.meter.snapshot()),
                                 eng.host.peak_nbytes))
                finally:
                    eng.close()
        (la, sa, ma, pa), (lb, sb, mb, pb) = runs
        assert la == lb and ma == mb and pa == pb
        for k in sa:
            assert np.array_equal(sa[k], sb[k]), k
        # the payloads themselves, through the coordinator
        with tempfile.TemporaryDirectory() as d:
            eng = _card_engine(d)
            try:
                c = eng.ckpt_c
                ys = [torch.randn(MB, S, CFG.d_model, device="cuda")
                      for _ in range(3)]
                for m, y in enumerate(ys):
                    c.put_ckpt(1, m, y)
                    c.put_grad(1, m, y * 2)
                for m, y in enumerate(ys):
                    assert torch.equal(c.get_ckpt_fwd(1, m), y)
                    assert torch.equal(c.get_grad(1, m), y * 2)
                    assert torch.equal(c.get_ckpt_bwd(1, m), y)
                    c.drop_ckpt(1, m)
                assert c.pool.free() == c.pool.nslots
            finally:
                eng.close()
    finally:
        torch.use_deterministic_algorithms(False)


def _state_card(eng):
    out = {}
    for attr in ("p_vecs", "m_master", "m_m", "m_v"):
        for l, v in enumerate(getattr(eng, attr)):
            out[(attr, l)] = v.read().copy()
    for name in ("embed", "unembed", "final_norm"):
        out[name] = getattr(eng, name).detach().float().cpu().numpy()
    return out


@gpu
def test_plan_swap_rebuilds_the_pool_for_a_new_live_set():
    """The autotuner's hot swap: a swap that keeps the live set keeps the
    pool; a wave swap that changes it builds a new pool of the new live
    set, and the step after it equals, bitwise, a fresh engine compiled
    with the wave plan from a checkpoint of the same first step."""
    _card()
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True)
    try:
        with tempfile.TemporaryDirectory() as da, \
                tempfile.TemporaryDirectory() as db, \
                tempfile.TemporaryDirectory() as ck:
            a = _card_engine(da)
            try:
                la = [a.train_step(_batch(1))]
                pool = a.ckpt_c.pool
                a.apply_plan_config(prefetch_depth=0)
                assert a.ckpt_c.pool is pool
                a.apply_plan_config(wave_size=2, prefetch_depth=1)
                new = a.ckpt_c.pool
                assert new is not pool and new.pinned
                assert new.asked == _live(a)[0] == 7 != pool.asked
                assert all(b.is_pinned() for b in new.blocks)
                la.append(a.train_step(_batch(2)))
                a.finish()
                assert new.free() == new.nslots
                assert a.metrics_snapshot()["counters"]["pool_fallbacks"] \
                    == 0
                sa = _state_card(a)
            finally:
                a.close()
            b = _card_engine(db)
            try:
                assert b.train_step(_batch(1)) == la[0]
                b.save_checkpoint(ck)
            finally:
                b.close()
            with tempfile.TemporaryDirectory() as dc:
                c = _card_engine(dc, PLANS[1])
                try:
                    c.restore_checkpoint(ck)
                    assert c.train_step(_batch(2)) == la[1]
                    c.finish()
                    sc = _state_card(c)
                finally:
                    c.close()
        for k in sa:
            assert np.array_equal(sa[k], sc[k]), k
    finally:
        torch.use_deterministic_algorithms(False)
