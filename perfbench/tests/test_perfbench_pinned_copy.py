"""The ``pinned_copy_pct`` reader (``perfbench/metrics/pinned_copy_pct.py``)
on a synthetic window: pinned and pageable copies inside the steps give
the pinned bytes' share; copies outside the steps, on other tracks or of
other names do not count; a window without copies, a ring that dropped
spans, an untraced run and a program without the tracer hook give
``None``; a traced CPU run of each cell at SMOKE size reads 0 (the CPU
engine builds no pool)."""
from types import SimpleNamespace

import pytest

from harness import devtrace, spec
from repro_torch.obs import tracer as tracer_mod
from repro_torch.obs.tracer import Tracer

from test_perfbench_hostspans import CELLS, _CpuTrace, _smoke_run


def _read(w):
    return spec.readers([{"name": "pinned_copy_pct"}])["pinned_copy_pct"](w)


def _w():
    return SimpleNamespace(steps=2, tracer_dropped=0, device=SimpleNamespace(
        gaps=[], busy_s=1.0, window_s=5.0))


def _window(copies=True, capacity=1 << 10):
    """Two steps (0-2 s, 3-4 s); copies inside and outside them."""
    tr = Tracer(capacity)
    tr.enable()
    rec = tr.record
    rec("exec", "FWD", "plan", 0.0, 2.0, step=1)
    rec("exec", "BWD", "plan", 3.0, 4.0, step=2)
    rec("exec.host", "copy.wait", "sync", 0.05, 0.1, what="pool")
    if copies:
        rec("exec.host", "copy.d2h", "copy", 0.1, 0.2, nbytes=300,
            category="ckpt", pinned=True)
        rec("exec.host", "copy.h2d", "copy", 3.1, 3.2, nbytes=100,
            category="inter_grad", pinned=True)
        rec("exec.host", "copy.h2d", "copy", 1.0, 1.5, nbytes=100,
            category="param", pinned=False)
        # outside the steps, on a worker's track, not a copy: not counted
        rec("exec.host", "copy.h2d", "copy", 2.2, 2.4, nbytes=10**6,
            category="param", pinned=False)
        rec("io-req-0", "copy.d2h", "copy", 0.1, 0.2, nbytes=10**6,
            pinned=False)
        rec("exec.host", "host.stage", "copy", 0.3, 0.4, nbytes=10**6)
    tr.disable()
    return tr


def test_mixed_pinned_and_pageable():
    _window()
    assert _read(_w()) == pytest.approx(100.0 * 400 / 500)


def test_no_copy_gives_none():
    _window(copies=False)
    assert _read(_w()) is None


def test_dropped_spans_give_none():
    tr = _window(capacity=4)
    assert tr.dropped > 0
    assert _read(_w()) is None


def test_untraced_gives_none():
    _window()                       # an earlier traced window's tracer
    w = _w()
    w.device = None
    assert _read(w) is None


def test_no_tracer_hook_gives_none(monkeypatch):
    _window()
    monkeypatch.delattr(tracer_mod, "last")
    assert _read(_w()) is None


@pytest.mark.parametrize("cell", CELLS)
def test_traced_smoke_run_reads_zero_on_the_cpu(cell, monkeypatch):
    monkeypatch.setattr(devtrace, "DeviceTrace", _CpuTrace)
    result, _over, got = _smoke_run(cell, 1)
    assert got["pinned_copy_pct"] == 0.0
    assert result["correct"]
