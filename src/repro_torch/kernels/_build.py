"""Build the port's CUDA sources at first use.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface and loaded with ``ctypes`` (no
PyTorch headers, so a build takes seconds). Libraries land in
``repro_torch/_build/`` (listed in ``.gitignore``), named by a hash of
the source and the flags, so an edited source is rebuilt and an
unchanged one is reused. ``build_all`` starts one ``nvcc`` per source,
all at once, and waits for them together.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Tuple

PKG = Path(__file__).resolve().parents[1]
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"

#: every kernel source of the port (built together by ``build_all``)
SOURCES = ("flash_attention_fwd",)

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: Dict[str, ctypes.CDLL] = {}
_logs: Dict[str, str] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "the port's kernels")


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{tag}.so"


def _start(name: str) -> Tuple[Path, subprocess.Popen]:
    out = _target(name)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    return out, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)


def _finish(name: str, out: Path, proc: subprocess.Popen) -> str:
    log, _ = proc.communicate()
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed to build {name}:\n{log}")
    os.replace(tmp, out)
    (BUILD_DIR / f"{name}.log").write_text(log)
    return log


def build_all() -> Dict[str, str]:
    """Compile every source that has no up-to-date library, one ``nvcc``
    per source, all started together. Returns ``name -> nvcc log`` (the
    ``-Xptxas -v`` report: registers, shared memory, spills)."""
    with _lock:
        started = {}
        for name in SOURCES:
            out = _target(name)
            if not out.exists():
                started[name] = _start(name)
        for name, (out, proc) in started.items():
            _logs[name] = _finish(name, out, proc)
        for name in SOURCES:
            if name not in _logs:
                log = BUILD_DIR / f"{name}.log"
                _logs[name] = log.read_text() if log.exists() else ""
        return dict(_logs)


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _loaded.get(name)
        if lib is not None:
            return lib
        out = _target(name)
        if not out.exists():
            _logs[name] = _finish(name, *_start(name))
        lib = ctypes.CDLL(str(out))
        _loaded[name] = lib
        return lib


def ptxas_report(name: str) -> List[str]:
    """The compiler's report of the last build of ``name`` (``-Xptxas -v``:
    registers, shared memory, stack, spills per kernel)."""
    return [ln for ln in _logs.get(name, "").splitlines() if ln.strip()]
