"""The readers of the program's host spans (``harness/hostspans.py``:
``host_copy_s_per_step``, ``opt_wait_s_per_step``, ``host_syncs_per_step``,
``adam_overlap_pct``): known spans, device gaps and steps give the known
values; a ring that dropped spans, an untraced run, and a program without
the tracer hook (as the one before these spans), give ``None``; a traced
CPU run of each cell at SMOKE size reports all four."""
import time
from types import SimpleNamespace

import pytest
import torch

from harness import devtrace, report, spec
from repro_torch.obs import tracer as tracer_mod
from repro_torch.obs.tracer import Tracer

from test_perfbench_run import smoke_overrides

READERS = ("host_copy_s_per_step", "opt_wait_s_per_step",
           "host_syncs_per_step", "adam_overlap_pct")
CELLS = [w["name"] for w in spec.benchmark()["workloads"]]


def _reader(name):
    return spec.readers([{"name": name}])[name]


def _window(capacity=1 << 10):
    """Two steps (0-2 s, 3-4 s) and ``finish()`` after them (4.5-5 s)."""
    tr = Tracer(capacity)
    tr.enable()
    rec = tr.record
    rec("exec", "FWD", "plan", 0.0, 1.0, step=1)
    rec("exec", "BWD", "plan", 1.0, 2.0, step=1)
    rec("exec", "FWD", "plan", 3.0, 4.0, step=2)
    # copies: 0.1-0.4 (two overlapping), 3.5-3.6; one outside the steps
    # and one on a worker's track, neither counted
    rec("exec.host", "copy.d2h", "copy", 0.1, 0.3, nbytes=1)
    rec("exec.host", "host.stage", "copy", 0.2, 0.4, nbytes=1)
    rec("exec.host", "copy.h2d", "copy", 3.5, 3.6, nbytes=1)
    rec("exec.host", "copy.h2d", "copy", 2.5, 2.7, nbytes=1)
    # the drain before a copy on the card: a wait, neither copy nor sync
    rec("exec.host", "copy.wait", "sync", 3.4, 3.5)
    rec("io-req-0", "copy.h2d", "copy", 0.0, 2.0, nbytes=1)
    # waits: 1.5-1.8 in step 1; finish()'s 4.5-5.0 outside the steps
    rec("exec.host", "opt.wait", "opt", 1.5, 1.8, kind="early", req=3)
    rec("exec.host", "opt.wait", "opt", 4.5, 5.0, kind="late", req=4)
    # syncs: three in the steps
    for t in (0.5, 1.2, 3.1):
        rec("exec.host", "sync", "sync", t, t + 0.05, what="loss")
    # the host Adam: 0-1 and 0.5-1.5 (union 1.5 s), 0.4 s of it idle card
    rec("io-req-0", "adam.update", "opt", 0.0, 1.0, seg="early")
    rec("io-req-1", "adam.update", "opt", 0.5, 1.5, seg="late")
    tr.disable()
    return tr


def _w():
    return SimpleNamespace(steps=2, tracer_dropped=0, device=SimpleNamespace(
        gaps=[(5.0, 6.0), (0.8, 1.2)], busy_s=1.0, window_s=5.0))


@pytest.mark.parametrize("name,value", [
    ("host_copy_s_per_step", (0.3 + 0.1) / 2),
    ("opt_wait_s_per_step", 0.3 / 2),
    ("host_syncs_per_step", 3 / 2),
    ("adam_overlap_pct", 100.0 * (1.5 - 0.4) / 1.5)])
def test_reader_on_a_known_window(name, value):
    _window()
    assert _reader(name)(_w()) == pytest.approx(value)


@pytest.mark.parametrize("name", READERS)
def test_reader_gives_none_when_spans_dropped(name):
    tr = _window(capacity=4)
    assert tr.dropped > 0
    assert _reader(name)(_w()) is None


@pytest.mark.parametrize("name", READERS)
def test_reader_gives_none_without_the_tracer_hook(name, monkeypatch):
    _window()
    monkeypatch.delattr(tracer_mod, "last")
    assert _reader(name)(_w()) is None


def test_adam_overlap_needs_the_device_trace():
    _window()
    w = _w()
    w.device = None
    assert _reader("adam_overlap_pct")(w) is None


@pytest.mark.parametrize("name", READERS)
def test_reader_gives_none_when_untraced(name):
    _window()                       # an earlier traced window's tracer
    w = _w()
    w.device = None
    assert _reader(name)(w) is None


class _CpuTrace:
    """The device trace's surface on the CPU: the whole window idle."""

    def __init__(self):
        self.busy_s = self.window_s = 0.0
        self.gaps, self.by_name = [], {}

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self):
        t1 = time.perf_counter()
        self.window_s = t1 - self._t0
        self.gaps = [(self._t0, t1)]

    def kernel_time(self, patterns):
        return 0.0, 0

    def top_ops(self, k=10):
        return []


def _smoke_run(cell, trace):
    """A CPU run of ``cell`` at its SMOKE widths; the result and the
    metrics' values."""
    bench = spec.benchmark()
    c = spec.cell(bench, cell)
    over = smoke_overrides(spec.config(bench, c["config"]), "float32")
    args = SimpleNamespace(seed=2**31 + 5, seconds=0.5, trace=trace,
                           controls="")
    ctx = report.context(bench, c, args, device=torch.device("cpu"),
                         t_start=time.perf_counter(), log=lambda m: None,
                         check_modules=lambda: None, overrides=over)
    result, _ = report.run_cell(ctx)
    return result, over, {k: v["value"]
                          for k, v in result["metrics"].items()}


@pytest.mark.parametrize("cell", CELLS)
def test_traced_smoke_run_reports_the_host_metrics(cell, monkeypatch):
    monkeypatch.setattr(devtrace, "DeviceTrace", _CpuTrace)
    result, over, got = _smoke_run(cell, 1)
    assert set(READERS) <= set(got), got
    assert result["window"]["tracer_dropped"] == 0
    M = over["mix"]["micro_batches"]
    assert got["host_syncs_per_step"] == M + 1
    assert got["host_copy_s_per_step"] > 0
    assert got["opt_wait_s_per_step"] >= 0
    assert got["adam_overlap_pct"] == 0.0          # the CPU "card" idles
    assert result["correct"]

