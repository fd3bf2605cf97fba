"""The port stands alone: importing ``repro_torch`` and every module in it
loads neither ``jax``, nor anything of the JAX package ``repro``, nor
``ml_dtypes`` (a dependency of JAX, absent where the card is), nor the
reference's ``benchmarks`` scripts, and no source of the port (or
``chip_smoke.py``) imports them."""
import os
import re
import subprocess
import sys

import pytest

pytest.importorskip("torch")

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
PORT = os.path.join(ROOT, "src", "repro_torch")

_PROBE = r"""
import importlib, pkgutil, sys
import repro_torch
names = ["repro_torch"]
for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    importlib.import_module(m.name)
    names.append(m.name)
bad = sorted(n for n in sys.modules
             if n.split(".")[0] in ("jax", "repro", "ml_dtypes", "benchmarks"))
print(",".join(names), bad)
"""

#: modules the walk must reach: the training side's last slice (the LP
#: search, reconciliation, the autotuner and the data-parallel engine)
#: beside the engines they join, the front door (micro-batching, the
#: in-memory Trainer and its checkpoints, the training CLI, the kernel
#: benchmark and the six examples), whose scripts parse their arguments
#: only inside ``main``, and the attention architectures (MoE, its
#: expert-parallel seam and the five configs), the hybrid family's
#: config, and the launch layer (the mesh, the spec rules, the
#: collectives and the sharded jobs)
REQUIRED = {"repro_torch.core.lp_search", "repro_torch.obs.reconcile",
            "repro_torch.obs.registry", "repro_torch.offload.autotune",
            "repro_torch.offload.dp", "repro_torch.offload.engine",
            "repro_torch.offload.executor", "repro_torch.offload.checkpoint",
            "repro_torch.data.microbatch", "repro_torch.train",
            "repro_torch.train.loop", "repro_torch.train.checkpoint",
            "repro_torch.launch", "repro_torch.launch.train",
            "repro_torch.bench", "repro_torch.bench.common",
            "repro_torch.bench.kernels", "repro_torch.examples",
            "repro_torch.examples.train_gpt100m",
            "repro_torch.examples.offload_ssd_demo",
            "repro_torch.examples.train_dp",
            "repro_torch.examples.lp_config_search",
            "repro_torch.examples.serve_batched",
            "repro_torch.examples.quickstart",
            "repro_torch.models.moe", "repro_torch.models.moe_ep",
            "repro_torch.configs.phi3_medium_14b",
            "repro_torch.configs.starcoder2_7b",
            "repro_torch.configs.gemma3_1b",
            "repro_torch.configs.deepseek_v2_lite_16b",
            "repro_torch.configs.qwen3_moe_235b_a22b",
            "repro_torch.configs.jamba_v01_52b",
            "repro_torch.launch.mesh", "repro_torch.launch.shardings",
            "repro_torch.launch.collectives", "repro_torch.launch.sharded"}


def test_importing_every_module_loads_no_jax_and_no_reference():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    out = subprocess.run([sys.executable, "-c", _PROBE], capture_output=True,
                         text=True, env=env, cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr
    names, bad = out.stdout.strip().split(" ", 1)
    names = set(names.split(","))
    assert len(names) >= 30, out.stdout       # every module was imported
    assert REQUIRED <= names, REQUIRED - names
    assert bad == "[]", bad


_IMPORT = re.compile(
    r"^\s*(?:import\s+(jax|repro|ml_dtypes|benchmarks)\b(?!_)"
    r"|from\s+(jax|repro|ml_dtypes|benchmarks)(?:\.|\s)(?!_))", re.M)


def _sources():
    for d, _, files in os.walk(PORT):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)
    yield os.path.join(ROOT, "chip_smoke.py")


def test_no_source_imports_jax_or_the_reference():
    offenders = []
    for path in _sources():
        with open(path) as f:
            src = f.read()
        offenders += [f"{os.path.relpath(path, ROOT)}: {m.group(0).strip()}"
                      for m in _IMPORT.finditer(src)]
        # lazy imports inside functions and importlib strings count too
        offenders += [f"{os.path.relpath(path, ROOT)}: {m}" for m in
                      re.findall(r"[\"']repro\.[\w.]+[\"']", src)]
    assert offenders == []
    assert sum(1 for _ in _sources()) >= 30


def test_the_import_scan_catches_offenders():
    for bad in ("import jax", "from jax import numpy", "import repro.io",
                "from repro.models import model", "    from repro import x",
                "import ml_dtypes", "from ml_dtypes import bfloat16",
                "from benchmarks.common import Reporter"):
        assert _IMPORT.search(bad), bad
    for fine in ("import repro_torch", "from repro_torch.io import IOConfig",
                 "import jaxlib_free_module"):
        assert not _IMPORT.search(fine), fine
