"""Whole runs of each cell on the CPU at its configuration's SMOKE sizes
(the program's ``reduced()``: width 256, 4 heads, head size 32, FFN
1024, vocabulary 1024; 4 micro-batches of 64 tokens): the harness's
path without its look for a card, the program's ``OffloadEngine``
against the plain reference, and the faults a training cell can have
(a step that leaves its state unchanged, half of the batch left out; a
one-chip cell has no exchange between chips), and the fetch gate that
orders a step's α-tail flush before the next step's fetches left out,
each of which has to turn ``correct`` false. The control (the reference
in float8) is ``test_perfbench_control.py``'s."""
import time
from types import SimpleNamespace

import pytest
import torch

from harness import report, spec
from harness.traffic import half_batch

CELLS = [w["name"] for w in spec.benchmark()["workloads"]]


def smoke_overrides(cfg, param_dtype):
    """The program's SMOKE reduction of ``cfg`` (``ArchConfig.reduced``)."""
    from repro_torch.configs import get_smoke
    s = get_smoke(cfg["registry"])
    return {"config": {"d_model": s.d_model, "num_heads": s.num_heads,
                       "num_kv_heads": s.num_kv_heads,
                       "head_dim": s.head_dim, "d_ff": s.d_ff,
                       "vocab_size": s.vocab_size},
            "train": {"param_dtype": param_dtype},
            "mix": {"micro_batches": 4, "seq_len": 64}}


def run_cell(cell_name, param_dtype="bfloat16", fault=None, seed=7,
             controls="", mix=None):
    bench = spec.benchmark()
    cell = spec.cell(bench, cell_name)
    over = smoke_overrides(spec.config(bench, cell["config"]), param_dtype)
    over["mix"].update(mix or {})
    args = SimpleNamespace(seed=seed, seconds=0.5, trace=0,
                           controls=controls)
    ctx = report.context(bench, cell, args, device=torch.device("cpu"),
                         t_start=time.perf_counter(), log=lambda m: None,
                         check_modules=lambda: None, fault=fault,
                         overrides=over)
    return report.run_cell(ctx)


@pytest.mark.parametrize("cell", CELLS)
def test_f32_engine_equals_the_reference(cell):
    """In f32 the program and the reference compute the same arithmetic
    up to the order of sums: every number under 1e-5."""
    result, checks = run_cell(cell, "float32")
    for k, c in checks.items():
        assert c["value"] < 1e-5, (k, c)
    assert result["correct"]
    assert result["metrics"]["train_tokens_per_s"]["value"] > 0


@pytest.mark.parametrize("cell", CELLS)
def test_bf16_run_reports_every_number(cell):
    """The cell's own precision at SMOKE sizes: a result line with every
    key, each compared number finite and small. (Its limits are read at
    the cell's sizes on the card; rounding at width 256 is not rounding
    at width 4608.)"""
    result, checks = run_cell(cell, "bfloat16")
    assert list(result)[-1] == "checks"
    assert set(result) >= {"correct", "attempted", "failed", "metrics",
                           "device"}
    assert set(result["metrics"]) == {"train_tokens_per_s", "mfu",
                                      "setup_s"}
    for k, c in checks.items():
        assert 0 <= c["value"] < 1e-2, (k, c)


def _frozen(eng):
    """A step that returns its state unchanged: no optimizer writes."""
    eng.opt_c.adam.update = lambda *a, **k: None
    eng.j_adam_dev = lambda p, state, g, step, lr: p


def _half_batch(eng):
    """Half of the batch left out, the mean taken over the rest: the
    second half of the micro-batches repeat the first half."""
    split, ocfg = eng._split_tokens, eng.ocfg
    eng._split_tokens = lambda tokens: split(half_batch(
        tokens, ocfg.num_microbatches, ocfg.micro_batch))


def _no_alpha_gate(eng):
    """The fetch gate left out: a step's parameter fetches no longer wait
    for the previous step's α-tail flush, which lands late (as a slow
    host Adam would let it)."""
    run_tail = eng.opt_c._run_tail

    def late(l, tail):
        time.sleep(0.5)
        return run_tail(l, tail)
    eng.opt_c._run_tail = late
    eng.params_c.set_gate = lambda *a, **k: None


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", [_frozen, _half_batch, _no_alpha_gate],
                         ids=["unchanged_state", "half_batch",
                              "no_alpha_gate"])
def test_a_fault_turns_correct_false(cell, fault):
    """Under the cell's own limits, where the unbroken f32 run is correct
    (``test_f32_engine_equals_the_reference``)."""
    result, checks = run_cell(cell, "float32", fault=fault)
    assert not result["correct"], checks
    assert set(checks) == set(spec.limits(cell))
    assert not report.verdict(checks)
