"""Where the benchmark's data lives, found by the names in
``BENCHMARK.json``.

* a cell is an entry of ``workloads``;
* its configuration is the ``file`` of the ``configs`` entry it names;
* its traffic mix is ``perfbench/traffic/<traffic>.json``, whose
  ``kind`` names the driver ``perfbench/drivers/<kind>.py``;
* the limits of its correctness check are ``perfbench/limits/<cell>.json``;
* each metric is read by ``perfbench/metrics/<metric>.py``.

A later cell, configuration, traffic mix or metric is a new file and a
new entry; nothing here names one.
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Dict, List

PERFBENCH = Path(__file__).resolve().parents[1]
ROOT = PERFBENCH.parent


def _load_module(path: Path, name: str) -> ModuleType:
    if not path.is_file():
        raise FileNotFoundError(f"{path} is missing")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def read_json(path: Path) -> dict:
    if not path.is_file():
        raise FileNotFoundError(f"{path} is missing")
    return json.loads(path.read_text())


def benchmark(root: Path = ROOT) -> dict:
    return read_json(root / "BENCHMARK.json")


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(bench: dict, name: str, root: Path = ROOT) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return read_json(root / c["file"])
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def traffic(name: str) -> dict:
    return read_json(PERFBENCH / "traffic" / f"{name}.json")


def limits(cell_name: str) -> dict:
    return read_json(PERFBENCH / "limits" / f"{cell_name}.json")


def driver(kind: str) -> ModuleType:
    return _load_module(PERFBENCH / "drivers" / f"{kind}.py",
                        f"perfbench_driver_{kind}")


def metrics_for(bench: dict, cell_name: str, trace: bool) -> List[dict]:
    """The metrics a run of ``cell_name`` reports: the end-to-end ones
    without a trace, the per-layer ones with it; a metric that lists
    ``workloads`` only in those."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group
            if "workloads" not in m or cell_name in m["workloads"]]


def readers(metrics: List[dict]) -> Dict[str, object]:
    """Each metric's ``read(ctx)``, from ``perfbench/metrics/<name>.py``."""
    out = {}
    for m in metrics:
        mod = _load_module(PERFBENCH / "metrics" / f"{m['name']}.py",
                           "perfbench_metric_" + m["name"].replace(".", "_")
                           .replace("-", "_"))
        out[m["name"]] = mod.read
    return out
