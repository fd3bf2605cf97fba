"""The port's SSD-offloaded ``OffloadEngine`` on the CPU, inside the
port: the bitwise invariants of the reference's engine tests (alpha
split, lookahead depth, horizontal == vertical at M = 1), agreement with
the port's in-memory oracle, the mid-plan fault unwind, the default
device and the refusals of what later slices bring."""
import dataclasses
import tempfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config, get_smoke
from repro_torch.configs.base import ArchConfig
from repro_torch.core import ScheduleConfig, init_train_state, make_train_step
from repro_torch.core.perfmodel import StorageRatios
from repro_torch.data import SyntheticLM
from repro_torch.io import install_chaos
from repro_torch.models import model as mdl
from repro_torch.offload import (DataParallelOffloadEngine, OffloadConfig,
                                 OffloadEngine, offload_state)
from repro_torch.optim import AdamConfig

CFG = get_config("gpt-tiny")
M, MB, S = 4, 2, 64     # tests/test_offload_engine.py's engine shape


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """These shapes gain nothing from torch's intra-op threads, and under
    the parallel test workers every process's thread team contends for
    the same cores (a 10 s file ran ~25x slower)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ocfg(ratios, **kw):
    base = dict(num_microbatches=M, micro_batch=MB, seq_len=S)
    base.update(kw)
    return OffloadConfig(ratios=ratios, **base)


def _batches(steps, seed=0):
    data = SyntheticLM(CFG.vocab_size, seed=seed)
    return [data.batch(M * MB, S) for _ in range(steps)]


def _run_port(ocfg, batches, params=None):
    """(losses, traffic(), final master vectors) of one CPU engine run."""
    with tempfile.TemporaryDirectory() as d:
        eng = OffloadEngine(CFG, ocfg, 0, d, params=params, device="cpu")
        losses = [eng.train_step(b) for b in batches]
        eng.finish()
        traffic = eng.traffic()
        masters = np.concatenate([v.read() for v in eng.m_master])
        eng.close()
    return losses, traffic, masters


# ---------------------------------------------------------------------------
# bitwise invariants inside the port
# ---------------------------------------------------------------------------

def test_alpha_delay_is_bitwise_identical():
    """α = 0 and α = 0.25: the same losses and final master vectors,
    bitwise (the split composes to one Adam step; CpuAdam is
    element-wise)."""
    b = _batches(2)
    r = StorageRatios(0.5, 0.5, 0.5)
    l0, _, m0 = _run_port(_ocfg(r), b)
    la, _, ma = _run_port(_ocfg(r, alpha=0.25), b)
    assert l0 == la
    np.testing.assert_array_equal(m0, ma)


def test_prefetch_depth_is_bitwise_and_byte_identical():
    """Lookahead hints move bytes earlier, never change them or a bit of
    the result: depth 0 (no hints, prologue flush) == depth 1."""
    b = _batches(2)
    r = StorageRatios(0.5, 0.5, 0.5)
    l0, t0, m0 = _run_port(_ocfg(r, alpha=0.25, prefetch_depth=0), b)
    l1, t1, m1 = _run_port(_ocfg(r, alpha=0.25, prefetch_depth=1), b)
    assert l0 == l1
    np.testing.assert_array_equal(m0, m1)
    t0.pop("host:peak_nbytes")
    t1.pop("host:peak_nbytes")
    assert t0 == t1


def test_horizontal_m1_equals_vertical_bitwise():
    """At M = 1 the schedules coincide (test_plan_executor.py's pin), and
    training progresses."""
    data = SyntheticLM(CFG.vocab_size, seed=0)
    b = [data.batch(MB, S) for _ in range(3)]
    r = StorageRatios(0.5, 0.5, 0.0)
    lv, _, _ = _run_port(_ocfg(r, num_microbatches=1), b)
    lh, _, _ = _run_port(_ocfg(r, num_microbatches=1,
                                  schedule="horizontal"), b)
    assert lv == lh
    assert lh[2] != lh[0]


def test_engine_matches_in_memory_oracle():
    """The engine against the port's in-memory ``make_train_step``
    (vertical, M micro-batches as one batch) from the same f32 params:
    step 1 within 1e-5 relative; step 2 within 1e-3, because the oracle
    (as the reference's ``apply_update``) trains bf16 params cast from
    its f32 masters after step 1 while the f32 engine keeps f32."""
    params = mdl.init_params(CFG, 5, dtype=torch.float32, device="cpu")
    b = _batches(2, seed=1)
    tl, _, _ = _run_port(_ocfg(StorageRatios(0.5, 0.5,
                                                               0.5),
                                  alpha=0.25), b,
                            params=offload_state(CFG, params))
    step = make_train_step(CFG, ScheduleConfig(num_microbatches=M),
                           AdamConfig(lr=1e-3))
    _, opt = init_train_state(CFG, params=params)
    ol = []
    p = params
    for tok in b:
        p, opt, m = step(p, opt, {"tokens": torch.from_numpy(tok)})
        ol.append(float(m["loss"]))
    np.testing.assert_allclose(tl[0], ol[0], rtol=1e-5)
    np.testing.assert_allclose(tl[1], ol[1], rtol=1e-3)


# ---------------------------------------------------------------------------
# faults and refusals
# ---------------------------------------------------------------------------

TINY = ArchConfig(name="plan-tiny", family="dense", source="test",
                  num_layers=2, d_model=32, num_heads=2, num_kv_heads=2,
                  head_dim=16, d_ff=64, vocab_size=256, act="gelu")


def _assert_clean(eng):
    assert eng.ckpt_c._device_kept == {}, "leaked device-kept tensors"
    assert eng.ckpt_c._pending == {}, "leaked in-flight spills"
    assert eng.params_c._futures == {}, "leaked param prefetches"
    assert eng.host.nbytes() == 0, "leaked host buffers"


@pytest.mark.parametrize("fault", ["fail_reads", "fail_writes"])
def test_mid_plan_fault_releases_slots_and_recovers(fault):
    """A failing parameter fetch (forward) or checkpoint spill (surfacing
    mid-backward) is the step's exception; the executor releases every
    slot and buffer, and the next step runs (test_plan_executor.py's
    fault battery, with the port's chaos backend)."""
    with tempfile.TemporaryDirectory() as d:
        eng = OffloadEngine(TINY, OffloadConfig(
            num_microbatches=4, micro_batch=1, seq_len=16,
            ratios=StorageRatios(0.0, 0.0, 0.0)), 3, d, device="cpu")
        install_chaos(eng.ssd)                  # init writes stay intact
        data = SyntheticLM(TINY.vocab_size, seed=0)
        setattr(eng.ssd.files, fault, 1)
        with pytest.raises(OSError, match="injected"):
            eng.train_step(data.batch(4, 16))
        _assert_clean(eng)
        assert np.isfinite(eng.train_step(data.batch(4, 16)))
        eng.finish()
        _assert_clean(eng)
        eng.close()


def test_engine_defaults_to_the_card(monkeypatch):
    """No ``device``: the engine runs on ``cuda`` and, without a card,
    raises instead of training on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with tempfile.TemporaryDirectory() as d:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            OffloadEngine(TINY, OffloadConfig(), 0, d)


def test_later_slices_raise_naming_them():
    with pytest.raises(NotImplementedError, match="families come with"):
        with tempfile.TemporaryDirectory() as d:
            OffloadEngine(get_smoke("falcon-mamba-7b"), OffloadConfig(), 0,
                          d, device="cpu")
    with tempfile.TemporaryDirectory() as d:
        eng = OffloadEngine(TINY, OffloadConfig(micro_batch=1, seq_len=16,
                                                activation_policy="spill"),
                            0, d, device="cpu")
        assert eng.act_policy == "spill"
        # the plan hot swap and the data-parallel engine have landed; what
        # they still refuse is what the reference refuses
        eng.apply_plan_config(prefetch_depth=2)
        assert eng.ocfg.prefetch_depth == 2
        eng.close()
        with pytest.raises(ValueError, match="vertical"):
            DataParallelOffloadEngine(
                TINY, OffloadConfig(schedule="horizontal"), 0, d,
                device="cpu")
    with pytest.raises(ValueError, match="param_dtype"):
        OffloadConfig(param_dtype="float16")
    with pytest.raises(NotImplementedError, match="slice"):
        mdl.loss_fn({}, dataclasses.replace(CFG, family="vlm"),
                    {"tokens": torch.zeros((1, 4), dtype=torch.long)})
