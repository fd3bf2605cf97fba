"""Build the port's CUDA and host C++ sources at first use.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a``, and each
host source ``csrc/<name>.cpp`` by the system C++ compiler, into a
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
SOURCES = ("flash_attention_fwd", "flash_attention_bwd", "fused_adam",
           "selective_scan")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: the host sources (``csrc/<name>.cpp``), built by the system C++ compiler
HOST_SOURCES = ("cpu_adam",)

#: plain ``-O3`` with no contraction into fused multiply-adds, no
#: ``-ffast-math`` and no ``-march``: the host Adam must give numpy's
#: bits, and a library may be reused on another host
CXX_FLAGS = ("-std=c++17", "-O3", "-ffp-contract=off", "-fno-math-errno",
             "-fPIC", "-shared", "-pthread")

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


def _cxx() -> str:
    found = shutil.which("g++")
    if found:
        return found
    raise RuntimeError("g++ not found: a C++ compiler is needed to build "
                       "the port's host sources (csrc/*.cpp)")


def _source(name: str) -> Path:
    return CSRC / (f"{name}.cpp" if name in HOST_SOURCES else f"{name}.cu")


def _flags(name: str) -> Tuple[str, ...]:
    return CXX_FLAGS if name in HOST_SOURCES else NVCC_FLAGS


def _target(name: str) -> Path:
    src = _source(name).read_bytes()
    tag = hashlib.sha256(src + " ".join(_flags(name)).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{tag}.so"


def _start(name: str) -> Tuple[Path, subprocess.Popen]:
    out = _target(name)
    compiler = _cxx() if name in HOST_SOURCES else _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [compiler, *_flags(name), "-o", str(tmp), str(_source(name))]
    return out, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)


def _finish(name: str, out: Path, proc: subprocess.Popen) -> str:
    log, _ = proc.communicate()
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    if proc.returncode != 0:
        raise RuntimeError(f"{Path(proc.args[0]).name} failed to build "
                           f"{name}:\n{log}")
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
    """The loaded library of ``csrc/<name>.cu`` (or ``.cpp``, a host
    source), built on first use."""
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
