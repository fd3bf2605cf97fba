"""The port's Algorithm-1 LP search (``repro_torch.core.lp_search``)
against the reference's on ``tests/test_lp_search.py``'s inputs: the
GPT-65B workload at micro-batch 2 x 2048 tokens on the default machine,
across n, α, the activation policy, the lookahead flag, the wave hybrid,
the data-parallel rank count and the path policy. Both sides call HiGHS
through ``scipy.optimize.linprog``; HiGHS versions differ between
installations, so answers are held at a stated tolerance (iteration time
rtol 1e-6, storage ratios atol 1e-6), feasibility exactly."""
import dataclasses

import pytest

pytest.importorskip("torch")

from repro.configs import get_config as jax_config
from repro.core import lp_search as jlp
from repro.core.perfmodel import MachineParams as JaxMachine
from repro.core.perfmodel import Workload as JaxWorkload
from repro_torch.configs import get_config
from repro_torch.core import lp_search as tlp
from repro_torch.core.perfmodel import MachineParams, Workload

RTOL, XTOL = 1e-6, 1e-6


def _workloads(mb=2, seq=2048):
    return (JaxWorkload.from_config(jax_config("gpt-65b"), micro_batch=mb,
                                    seq_len=seq),
            Workload.from_config(get_config("gpt-65b"), micro_batch=mb,
                                 seq_len=seq))


def test_workload_and_machine_match_reference():
    jw, tw = _workloads()
    assert dataclasses.asdict(tw) == dataclasses.asdict(jw)
    assert dataclasses.asdict(MachineParams()) == \
        dataclasses.asdict(JaxMachine())


def _same(js, ts):
    """Both infeasible, or both feasible with the same answer."""
    assert (js is None) == (ts is None)
    if js is None:
        return
    assert ts.iteration_time == pytest.approx(js.iteration_time, rel=RTOL)
    assert ts.t_f == pytest.approx(js.t_f, rel=RTOL, abs=1e-12)
    assert ts.t_b == pytest.approx(js.t_b, rel=RTOL, abs=1e-12)
    for f in ("ckpt", "param", "opt"):
        assert getattr(ts.x, f) == pytest.approx(getattr(js.x, f), abs=XTOL)
    assert (ts.act_policy, ts.path_policy) == (js.act_policy, js.path_policy)


#: (n, alpha, keyword arguments): test_lp_search.py's points (n 4 / 8 /
#: 16 / 48 at alpha 0, 0.2, 0.3, 0.5; the DP, wave, policy and lookahead
#: variants of its contract tests) plus the infeasible host
CASES = [
    (4, 0.0, {}), (4, 0.3, {}), (8, 0.2, {}), (8, 0.5, {}),
    (16, 0.0, {}), (16, 0.3, {}), (48, 0.0, {}), (48, 0.3, {}),
    (8, 0.2, {"act_policy": "spill"}), (8, 0.2, {"act_policy": "auto"}),
    (8, 0.2, {"lookahead": False}),
    (8, 0.2, {"act_policy": "spill", "lookahead": False}),
    (8, 0.2, {"wave": 2}), (8, 0.2, {"wave": 4, "act_policy": "spill"}),
    (8, 0.2, {"num_gpus": 2}), (8, 0.0, {"num_gpus": 4}),
    (8, 0.2, {"path_policy": "backlog"}),
    (8, 0.5, {"machine": {"cpu_mem": 1e6}}),
    (8, 0.5, {"machine": {"cpu_mem": 1e6}, "act_policy": "auto"}),
]


@pytest.mark.parametrize("n,alpha,kw", CASES)
def test_solve_config_matches_reference(n, alpha, kw):
    kw = dict(kw)
    over = kw.pop("machine", {})
    jw, tw = _workloads()
    js = jlp.solve_config(dataclasses.replace(JaxMachine(), **over), jw, n,
                          alpha, **kw)
    ts = tlp.solve_config(dataclasses.replace(MachineParams(), **over), tw,
                          n, alpha, **kw)
    _same(js, ts)
    if over:
        assert ts is None          # the host that caches nothing is infeasible


@pytest.mark.parametrize("kw,match", [
    ({"n": 9, "num_gpus": 2}, "divisible"),
    ({"n": 8, "num_gpus": 2, "wave": 4}, "wave"),
    ({"n": 8, "wave": 3}, "divisor"),
    ({"n": 8, "act_policy": "levitate"}, "act_policy"),
    ({"n": 8, "path_policy": "teleport"}, "path_policy"),
])
def test_solve_config_argument_errors_match_reference(kw, match):
    jw, tw = _workloads()
    for mod, m, w in ((jlp, JaxMachine(), jw), (tlp, MachineParams(), tw)):
        with pytest.raises(ValueError, match=match):
            mod.solve_config(m, w, alpha=0.2, **kw)


@pytest.mark.parametrize("num_gpus,max_n", [(1, 64), (2, 16)])
def test_find_optimal_config_matches_reference(num_gpus, max_n):
    """Algorithm 1's outer search: the same saturating n, the same α*,
    the same storage split and throughput."""
    jw, tw = _workloads()
    alphas = [0.0, 0.2, 0.4]
    jr = jlp.find_optimal_config(JaxMachine(), jw, alphas=alphas,
                                 max_n=max_n, num_gpus=num_gpus)
    tr = tlp.find_optimal_config(MachineParams(), tw, alphas=alphas,
                                 max_n=max_n, num_gpus=num_gpus)
    assert jr is not None and tr is not None
    assert (tr.n, tr.alpha) == (jr.n, jr.alpha)
    assert tr.iteration_time == pytest.approx(jr.iteration_time, rel=RTOL)
    assert tr.throughput_tokens_per_s == pytest.approx(
        jr.throughput_tokens_per_s, rel=RTOL)
    for f in ("ckpt", "param", "opt"):
        assert getattr(tr.x, f) == pytest.approx(getattr(jr.x, f), abs=XTOL)
    assert tr.n % num_gpus == 0
