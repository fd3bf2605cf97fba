"""The port stands alone: importing ``repro_torch`` and every module in it
loads neither ``jax`` nor anything of the JAX package ``repro``, and no
source of the port (or ``chip_smoke.py``) imports them."""
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
             if n == "jax" or n.startswith("jax.") or n == "repro"
             or n.startswith("repro."))
print(len(names), bad)
"""


def test_importing_every_module_loads_no_jax_and_no_reference():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    out = subprocess.run([sys.executable, "-c", _PROBE], capture_output=True,
                         text=True, env=env, cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr
    count, bad = out.stdout.strip().split(" ", 1)
    assert int(count) >= 30, out.stdout       # every module was imported
    assert bad == "[]", bad


_IMPORT = re.compile(
    r"^\s*(?:import\s+(jax|repro)\b(?!_)|from\s+(jax|repro)(?:\.|\s)(?!_))",
    re.M)


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
                "from repro.models import model", "    from repro import x"):
        assert _IMPORT.search(bad), bad
    for fine in ("import repro_torch", "from repro_torch.io import IOConfig",
                 "import jaxlib_free_module"):
        assert not _IMPORT.search(fine), fine
