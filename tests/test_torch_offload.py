"""The port's SSD-offloaded ``OffloadEngine`` on the CPU against the
reference's ``OffloadEngine``, from the same initial state
(``weights.offload_state_from_jax``): per-step losses, the measured
byte meters, ``plan_traffic``, ``PlanCosts.from_engine`` and the
metrics snapshot's schema, across schedules, α and the param dtype."""
import dataclasses
import tempfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax

from repro.configs import get_config as jax_config
from repro.core.perfmodel import StorageRatios as JaxRatios
from repro.core.plan import PlanCosts as JaxPlanCosts
from repro.core.plan import plan_traffic as jax_plan_traffic
from repro.offload import OffloadConfig as JaxOffloadConfig
from repro.offload import OffloadEngine as JaxOffloadEngine
from repro_torch.configs import get_config
from repro_torch.core.perfmodel import StorageRatios
from repro_torch.core.plan import PlanCosts, plan_traffic
from repro_torch.data import SyntheticLM
from repro_torch.offload import OffloadConfig, OffloadEngine
from repro_torch.weights import offload_state_from_jax

CFG = get_config("gpt-tiny")
JCFG = jax_config("gpt-tiny")
M, MB, S = 4, 2, 64     # tests/test_offload_engine.py's engine shape


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """These shapes gain nothing from torch's intra-op threads, and under
    the parallel test workers every process's thread team contends for
    the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_ocfg(ratios, **kw):
    return JaxOffloadConfig(num_microbatches=M, micro_batch=MB, seq_len=S,
                            ratios=ratios, **kw)


def _port_ocfg(ratios, **kw):
    return OffloadConfig(num_microbatches=M, micro_batch=MB, seq_len=S,
                         ratios=ratios, **kw)


def _run_port(ocfg, batches, params):
    """(losses, traffic(), plan_traffic) of one CPU engine run."""
    with tempfile.TemporaryDirectory() as d:
        eng = OffloadEngine(CFG, ocfg, 0, d, params=params, device="cpu")
        losses = [eng.train_step(b) for b in batches]
        eng.finish()
        traffic = eng.traffic()
        pred = plan_traffic(eng.plan, PlanCosts.from_engine(eng))
        eng.close()
    return losses, traffic, pred


#: per-step loss tolerance against the reference engine, by param dtype.
#: f32: the same math summed in another order. bf16: XLA's CPU products
#: and torch's round their bf16 inputs and partial sums differently
#: (measured up to 3.6e-5); a skipped early layer update or a lost alpha
#: tail moves the step-2 loss by 1.4e-3 or more, so both still fail.
LOSS_RTOL = {"float32": 1e-5, "bfloat16": 2e-4}


@pytest.mark.parametrize("schedule,W", [("vertical", 0), ("horizontal", 0),
                                        ("wave", 2)])
@pytest.mark.parametrize("alpha", [0.0, 0.25])
@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_engine_matches_jax_engine(schedule, W, alpha, param_dtype):
    """The port's engine on the CPU from the reference engine's initial
    state (``offload_state_from_jax``), ratios (0.5, 0.5, 0.5): per-step
    losses within ``LOSS_RTOL`` relative, and the measured byte meters
    and the ``plan_traffic`` map exactly the reference's. In bf16 this
    runs the host tiers as uint16 bits, the host f32 -> bf16 cast of the
    updated masters and K2's bf16 head update. ``traffic()``'s
    ``host:peak_nbytes`` is left out: it depends on how the optimizer
    worker threads interleave with the executor on each side."""
    kw = dict(schedule=schedule, wave_size=W, alpha=alpha,
              param_dtype=param_dtype)
    data = SyntheticLM(CFG.vocab_size, seed=0)
    batches = [data.batch(M * MB, S) for _ in range(2)]
    with tempfile.TemporaryDirectory() as d:
        je = JaxOffloadEngine(JCFG, _jax_ocfg(JaxRatios(0.5, 0.5, 0.5),
                                              **kw),
                              jax.random.PRNGKey(7), d)
        state = offload_state_from_jax(je)
        je.meter.reset()
        jl = [je.train_step(b) for b in batches]
        je.finish()
        jt = je.traffic()
        jpred = jax_plan_traffic(je.plan, JaxPlanCosts.from_engine(je))
        je.close()
    tl, tt, tpred = _run_port(
        _port_ocfg(StorageRatios(0.5, 0.5, 0.5), **kw), batches, state)
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL[param_dtype])
    jt.pop("host:peak_nbytes")
    tt.pop("host:peak_nbytes")
    assert tt == jt
    assert dict(tpred) == dict(jpred)
    assert {f"{c}:{r}": 2 * v for (c, r), v in tpred.items()} == tt


def test_plan_costs_and_snapshot_match_jax_engine():
    """``PlanCosts.from_engine`` field by field (bf16 params) and the
    metrics snapshot's keys against the reference engine's.
    ``act_res_bytes`` is the residual payload only the activation-spill
    policy prices: the reference's vjp residuals, the port's autograd
    saved tensors (K1 saves q, k, v, out and lse where the reference's
    chunked attention keeps its own residuals), so both are sized but
    not equal; ``tests/test_torch_act.py`` holds the port's against its
    own ``plan_traffic``."""
    ratios = (0.5, 0.25, 0.75)
    with tempfile.TemporaryDirectory() as d1, \
            tempfile.TemporaryDirectory() as d2:
        je = JaxOffloadEngine(JCFG, _jax_ocfg(JaxRatios(*ratios),
                                              alpha=0.25,
                                              param_dtype="bfloat16"),
                              jax.random.PRNGKey(7), d1)
        te = OffloadEngine(CFG, _port_ocfg(StorageRatios(*ratios),
                                           alpha=0.25,
                                           param_dtype="bfloat16"),
                           0, d2, params=offload_state_from_jax(je),
                           device="cpu")
        jc = dataclasses.asdict(JaxPlanCosts.from_engine(je))
        tc = dataclasses.asdict(PlanCosts.from_engine(te))
        jsnap, tsnap = je.metrics_snapshot(), te.metrics_snapshot()
        je.close()
        te.close()
    assert jc.pop("act_res_bytes") > 0 and tc.pop("act_res_bytes") > 0
    assert tc == jc
    assert tc["param_itemsize"] == 2
    assert set(tsnap) == set(jsnap) - {"autotune"}
    assert set(tsnap["lookahead"]) == set(jsnap["lookahead"])
