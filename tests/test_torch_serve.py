"""The port's ServeEngine on the CPU: bitwise against the port's own
in-memory reference (f32, across a preempt/resume), the three-way KV
byte invariant, byte maps and serve plans identical to the JAX
``ServeEngine``'s, and per-step logits close to the JAX engine's with
the reference's weights."""
import contextlib
import json
import tempfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.configs import get_config as jget_config
from repro.models import model as jmdl
from repro.serve import ServeConfig as JServeConfig
from repro.serve import ServeEngine as JServeEngine
from repro.serve import compile_serve_step as jcompile
from repro_torch import tree
from repro_torch.configs import get_config
from repro_torch.core.traffic import kv_blocks, kv_traffic
from repro_torch.models import model as mdl
from repro_torch.offload import tree_from_bytes, tree_to_bytes
from repro_torch.serve import (ServeConfig, ServeEngine, compile_serve_step,
                               lint_kv_plan)
from repro_torch.weights import params_from_jax

CFG = get_config("gpt-tiny")
MAX_LEN = 12
PROMPT_LEN = 4
BB = 4096


def _blocks_per_request():
    template = mdl.init_caches(CFG, 1, MAX_LEN, dtype=torch.float32,
                               device="meta")
    return sum(kv_blocks(nb, BB) for nb in mdl.cache_unit_nbytes(CFG, template))


def _scfg(capacity_requests=8, **kw):
    return dict(max_len=MAX_LEN, kv_block_bytes=BB,
                kv_budget_bytes=capacity_requests * _blocks_per_request() * BB,
                **kw)


def _engine(workdir, *, params=None, capacity_requests=8, **kw):
    return ServeEngine(CFG, ServeConfig(**_scfg(capacity_requests, **kw)), 0,
                       workdir, params=params, device="cpu")


def _prompts(n, seed=0):
    rng = np.random.default_rng(seed)
    return [[int(t) for t in rng.integers(0, CFG.vocab_size, PROMPT_LEN)]
            for _ in range(n)]


def _drain(eng, preempt_rid=None, preempt_after=2):
    steps = 0
    while eng.pending():
        eng.step()
        steps += 1
        if preempt_rid is not None and steps == preempt_after and \
                eng.requests[preempt_rid].state == "running":
            eng.preempt(preempt_rid)
        assert steps < 200, "serve loop did not converge"


def _assert_three_way(eng):
    eng.kv_coord.wait_pending()     # finished requests' SSD spills are async
    measured = {k: int(v) for k, v in eng.meter.bytes.items()}
    predicted = {k: int(v) for k, v in eng.predicted_traffic.items()}
    assert measured == predicted
    kt = kv_traffic(eng.kv_unit_nbytes, eng.scfg.kv_block_bytes,
                    eng.scfg.kv_x_host, eng.kv_spills, eng.kv_fetches)
    assert measured.get(("kv", "gpu->cpu"), 0) == kt.spill
    assert measured.get(("kv", "cpu->ssd"), 0) == kt.ssd_spill
    assert measured.get(("kv", "cpu->gpu"), 0) == kt.fetch
    assert measured.get(("kv", "ssd->cpu"), 0) == kt.ssd_fetch
    steps = eng.step_num
    assert measured.get(("param", "cpu->gpu"), 0) == \
        steps * sum(eng.param_unit_nbytes)
    assert measured.get(("param", "ssd->cpu"), 0) == \
        steps * sum(nb - int(round(eng.scfg.param_x_host * nb))
                    for nb in eng.param_unit_nbytes)


def _reference(params, prompt, gen):
    """The port's in-memory B=1 decode — the bitwise f32 reference."""
    caches = mdl.init_caches(CFG, 1, MAX_LEN, dtype=torch.float32,
                             device="cpu")
    logits, caches = mdl.prefill(params, CFG,
                                 {"tokens": torch.tensor([prompt])}, caches)
    out, toks = [logits.numpy()], [int(torch.argmax(logits[0]))]
    for i in range(gen - 1):
        logits, caches = mdl.decode_step(params, CFG,
                                         torch.tensor([[toks[-1]]]),
                                         len(prompt) + i, caches)
        out.append(logits.numpy())
        toks.append(int(torch.argmax(logits[0])))
    return out, toks


# ---------------------------------------------------------------------------
# inside the port: bitwise + byte-exact
# ---------------------------------------------------------------------------
def test_preempt_to_ssd_and_resume_is_bitwise():
    prompts, gen = _prompts(2), 5
    params = mdl.init_params(CFG, 0, dtype=torch.float32, device="cpu")
    with tempfile.TemporaryDirectory() as d:
        eng = _engine(d, params=params, record_logits=True)
        rids = [eng.submit(p, gen) for p in prompts]
        eng.step()
        eng.step()
        eng.preempt(rids[0])
        _drain(eng)
        assert eng.requests[rids[0]].evictions >= 1
        for rid, prompt in zip(rids, prompts):
            ref_logits, ref_toks = _reference(params, prompt, gen)
            assert eng.result(rid) == ref_toks
            got = eng.requests[rid].logits
            assert len(got) == len(ref_logits) == gen
            for g, r in zip(got, ref_logits):
                np.testing.assert_array_equal(g, r)
        _assert_three_way(eng)
        eng.close()


def test_engine_leaves_callers_params_untouched():
    params = mdl.init_params(CFG, 0, dtype=torch.float32, device="cpu")
    before = {k: v.clone() for k, v in
              mdl.get_cache_unit(params, ("period", 0, 0))["mlp"].items()}
    with tempfile.TemporaryDirectory() as d:
        eng = _engine(d, params=params)
        eng.submit(_prompts(1)[0], 2)
        _drain(eng)
        eng.close()
    after = mdl.get_cache_unit(params, ("period", 0, 0))["mlp"]
    for k, v in before.items():
        assert torch.equal(after[k], v)


@pytest.mark.parametrize("kv_x,p_x", [(0.0, 1.0), (0.5, 0.5), (1.0, 0.0)])
@pytest.mark.parametrize("batch,gen", [(1, 2), (3, 3)])
def test_three_way_exactness_sweep(batch, gen, kv_x, p_x):
    with tempfile.TemporaryDirectory() as d:
        eng = _engine(d, capacity_requests=max(1, batch - 1),
                      kv_x_host=kv_x, param_x_host=p_x)
        rids = [eng.submit(p, gen) for p in _prompts(batch)]
        _drain(eng, preempt_rid=rids[0] if batch > 1 and gen > 2 else None)
        assert all(len(eng.result(r)) == gen for r in rids)
        _assert_three_way(eng)
        if batch > 1 and gen > 2:
            assert eng.preempted >= 1 and sum(eng.kv_fetches) > 0
        eng.close()


def test_serve_snapshot_round_trips_json():
    with tempfile.TemporaryDirectory() as d:
        eng = _engine(d, capacity_requests=1)
        rids = [eng.submit(p, 3) for p in _prompts(2)]
        _drain(eng, preempt_rid=rids[0])
        snap = eng.metrics_snapshot()
        again = json.loads(json.dumps(snap))
        assert again["schedule"] == "serve"
        assert again["kv"]["capacity_blocks"] == _blocks_per_request()
        assert 0.0 <= again["kv"]["hit_rate"] <= 1.0
        assert again["tokens_decoded"] == eng.tokens_decoded > 0
        meas = {k: int(v) for k, v in again["traffic"][0].items()}
        assert meas == {k: int(v) for k, v in again["predicted"].items()}
        eng.close()


def test_admission_refuses_oversized_and_overlong_requests():
    with tempfile.TemporaryDirectory() as d:
        eng = ServeEngine(CFG, ServeConfig(
            max_len=MAX_LEN, kv_block_bytes=BB,
            kv_budget_bytes=(_blocks_per_request() - 1) * BB), 0, d,
            device="cpu")
        with pytest.raises(ValueError, match="budget"):
            eng.submit(_prompts(1)[0], 2)
        with pytest.raises(ValueError, match="max_len"):
            eng.submit(list(range(PROMPT_LEN)), MAX_LEN)
        eng.close()


@pytest.mark.parametrize("kw", [
    {"kv_block_bytes": 0}, {"kv_budget_bytes": -1}, {"kv_x_host": 1.5},
    {"param_x_host": -0.1}, {"prefetch_depth": -1}, {"max_len": 1},
    {"param_dtype": "float33"},
])
def test_serve_config_rejects_bad_values_eagerly(kw):
    with pytest.raises(ValueError):
        ServeConfig(**kw)


def test_default_device_is_the_card(monkeypatch):
    """No ``device``: the engine runs on ``cuda`` and, without a card,
    raises instead of falling back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with tempfile.TemporaryDirectory() as d:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ServeEngine(CFG, ServeConfig(**_scfg()), 0, d)


def test_tree_bytes_round_trip_is_bitwise_across_dtypes():
    """Leaves of mixed item sizes — including an f32 leaf at a byte
    offset that is not a multiple of 4 — come back bit for bit, in the
    same structure."""
    g = torch.Generator().manual_seed(0)
    t = {"b": (torch.randn(3, generator=g).to(torch.bfloat16),
               torch.randn(2, 5, generator=g)),
         "a": mdl.init_caches(CFG, 1, 3, dtype=torch.bfloat16,
                              device="cpu")["prefix"],
         "c": torch.arange(7, dtype=torch.int32)}
    buf, treedef, metas = tree_to_bytes(t)
    assert buf.dtype == np.uint8
    back = tree_from_bytes(torch.from_numpy(buf), treedef, metas)
    for x, y in zip(tree.leaves(t), tree.leaves(back)):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x.view(-1).view(torch.uint8) if x.dim() else x,
                           y.reshape(-1).view(torch.uint8) if y.dim() else y)
    assert tree.unflatten(treedef, tree.leaves(back))["c"].tolist() == \
        list(range(7))


# ---------------------------------------------------------------------------
# against the JAX engine
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("evict,resume,prefill,decode,depth", [
    ((), (), (0, 1), (), 1),
    ((0,), (0,), (), (1,), 2),
    ((0, 1), (2, 3), (4,), (5,), 3),
    ((0,), (), (), (1, 2), 0),
])
def test_serve_plans_equal_reference(evict, resume, prefill, decode, depth):
    ours = compile_serve_step(4, evict=evict, resume=resume, prefill=prefill,
                              decode=decode, prefetch_depth=depth)
    theirs = jcompile(4, evict=evict, resume=resume, prefill=prefill,
                      decode=decode, prefetch_depth=depth)
    assert _ops(ours) == _ops(theirs)
    assert lint_kv_plan(ours) == []


def _ops(plan):
    return [(op.op.name, op.l, op.m, op.tag) for op in plan.ops]


@contextlib.contextmanager
def _run_pair(capacity_requests, gen, batch, kv_x, p_x, preempt_after):
    """The same requests and preempt schedule through both engines, with
    the reference's f32 weights in both."""
    jcfg = jget_config("gpt-tiny")
    jparams = jmdl.init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)
    params = params_from_jax(jax.tree.map(np.asarray, jparams))
    kw = dict(kv_x_host=kv_x, param_x_host=p_x, record_logits=True)
    prompts = _prompts(batch, seed=3)
    with tempfile.TemporaryDirectory() as d1, \
            tempfile.TemporaryDirectory() as d2:
        jeng = JServeEngine(jcfg, JServeConfig(**_scfg(capacity_requests,
                                                       **kw)),
                            jax.random.PRNGKey(0), d1)
        eng = _engine(d2, params=params, capacity_requests=capacity_requests,
                      **kw)
        try:
            for e in (jeng, eng):
                rids = [e.submit(p, gen) for p in prompts]
                _drain(e, preempt_rid=rids[0], preempt_after=preempt_after)
                e.kv_coord.wait_pending()   # let async SSD spills meter
            yield jeng, eng
        finally:
            jeng.close()
            eng.close()


@pytest.mark.parametrize("capacity,batch,gen,kv_x,p_x", [
    (8, 2, 4, 0.5, 0.5), (1, 3, 3, 0.0, 1.0), (2, 3, 5, 1.0, 0.0),
])
def test_byte_maps_equal_reference_engine(capacity, batch, gen, kv_x, p_x):
    with _run_pair(capacity, gen, batch, kv_x, p_x, 2) as (jeng, eng):
        assert eng.kv_unit_nbytes == jeng.kv_unit_nbytes
        assert eng.param_unit_nbytes == jeng.param_unit_nbytes
        assert {k: int(v) for k, v in eng.meter.bytes.items()} == \
            {k: int(v) for k, v in jeng.meter.bytes.items()}
        assert {k: int(v) for k, v in eng.predicted_traffic.items()} == \
            {k: int(v) for k, v in jeng.predicted_traffic.items()}
        assert (eng.kv_spills, eng.kv_fetches, eng.step_num) == \
            (jeng.kv_spills, jeng.kv_fetches, jeng.step_num)
        assert _ops(eng.plan) == _ops(jeng.plan)


def test_per_step_logits_close_to_reference_engine():
    """Same weights, same schedule (with a preempt): every step's f32
    logits within 1e-4 of the JAX engine's (the two frameworks sum in
    other orders), hence the same greedy tokens."""
    with _run_pair(8, 5, 2, 0.5, 0.5, 2) as (jeng, eng):
        assert eng.preempted == jeng.preempted >= 1
        for rid in jeng.requests:
            assert eng.result(rid) == jeng.result(rid)
            got, want = eng.requests[rid].logits, jeng.requests[rid].logits
            assert len(got) == len(want) == 5
            for g, w in zip(got, want):
                np.testing.assert_allclose(g, np.asarray(w), atol=1e-4)
