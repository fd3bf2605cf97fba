"""BENCHMARK.json against the contract's rules, and every name in it
against the files the harness finds by that name."""
import json
import re

import pytest

from harness import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
TOP = {"command", "paths", "run_seconds", "configs", "workloads",
       "end_to_end", "per_layer"}


@pytest.fixture(scope="module")
def bench():
    return spec.benchmark()


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level_keys_and_size(bench):
    assert set(bench) == TOP
    assert len(json.dumps(bench)) <= 64 * 1024
    assert isinstance(bench["run_seconds"], int)
    assert 1 <= bench["run_seconds"] <= 51


def test_command_and_paths(bench):
    assert 1 <= len(bench["paths"]) <= 16
    for p in bench["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert not p.rstrip("/").endswith("_torch")
    cmd = bench["command"]
    assert 1 <= len(cmd) <= 32 and all(_line(w) for w in cmd)
    for w in cmd:
        assert not w.startswith("/") and ".." not in w
        if "/" in w:
            assert any(w.startswith(p.rstrip("/") + "/")
                       for p in bench["paths"])


def test_names_units_and_keys(bench):
    names = []
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        names.append(c["name"])
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        for k in ("name", "config", "traffic"):
            assert NAME.match(w[k])
        assert w["chips"] in (1, 4) and _line(w["why"])
        names.append(w["name"])
    for group in ("end_to_end", "per_layer"):
        for m in bench[group]:
            assert NAME.match(m["name"]) and UNIT.match(m["unit"])
            assert m["better"] in ("lower", "higher")
            assert m["source"] in SOURCES
            names.append(m["name"])
    assert len(names) == len(set(names))


def test_configs_are_used_and_match_their_files(bench):
    used = {w["config"] for w in bench["workloads"]}
    files = [c["file"] for c in bench["configs"]]
    assert len(files) == len(set(files))
    for c in bench["configs"]:
        assert c["name"] in used
        assert any(c["file"].startswith(p.rstrip("/") + "/")
                   for p in bench["paths"])
        f = spec.config(bench, c["name"])
        assert f["name"] == c["name"] and f["source"] == c["source"]
        assert f["reduced"] == c["reduced"]
        for k in f["reduced"]:
            assert k in f["published"] and f["published"][k] != f[k]
            assert not re.search(r"(_dim|_rank|hidden|intermediate|d_model"
                                 r"|d_ff|heads)", k)


def test_each_cell_has_its_files(bench):
    pairs = set()
    for w in bench["workloads"]:
        assert w["config"] in {c["name"] for c in bench["configs"]}
        mix = spec.traffic(w["traffic"])
        assert spec.driver(mix["kind"]).run
        limits = spec.limits(w["name"])
        assert set(limits) >= {"loss_gap", "grad_norm_gap",
                               "change_norm_gap"}
        pairs.add((w["config"], w["traffic"]))
    assert len(pairs) == len(bench["workloads"])
    four = sum(w["chips"] == 4 for w in bench["workloads"])
    assert four <= max(1, len(bench["workloads"]) // 4)


def test_end_to_end_metrics(bench):
    e2e = bench["end_to_end"]
    assert 1 <= len(e2e) <= 16
    assert "setup_s" in {m["name"] for m in e2e}
    for m in e2e:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25


def test_per_layer_metrics(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    cells = {w["name"] for w in bench["workloads"]}
    layers = set()
    for m in bench["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert _line(m["layer"]) and m["moves"] in e2e
        assert m["moves"] != "setup_s"
        layers.add(m["layer"])
        for c in m.get("workloads", []):
            assert c in cells
        if m["unit"] == "%" and "roofline" in m["name"]:
            assert m["name"].endswith("_roofline_pct") or \
                m["name"].endswith("_roofline")
    assert 1 <= len(bench["per_layer"]) <= 128
    # every cell reports setup_s, another end-to-end metric, a per-layer one
    for c in cells:
        assert len(spec.metrics_for(bench, c, False)) >= 2
        assert spec.metrics_for(bench, c, True)
    # a step's share of the peak beside the kernels' rooflines
    moved = {m["moves"] for m in bench["per_layer"] if "roofline" in m["name"]}
    for target in moved:
        assert any("mfu" in m["name"] and m["moves"] == target
                   for m in bench["per_layer"])


def test_every_metric_has_its_reader(bench):
    for group in ("end_to_end", "per_layer"):
        readers = spec.readers(bench[group])
        assert set(readers) == {m["name"] for m in bench[group]}


def test_a_full_check_fits_its_time(bench):
    cells = 24                  # later PRs may fill the benchmark
    runs = 2 + 14 * cells
    total = runs * (bench["run_seconds"] + 60) + cells * 2 * 90 + 1200
    assert total <= 43200
