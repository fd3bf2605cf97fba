"""Run one cell of the benchmark once and print its result.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell, its configuration, its traffic
mix, the limits of its correctness check and its metrics' readers are
found by the names in ``BENCHMARK.json`` (``harness/spec.py``). The last
line of standard output is one JSON object (``correct``, ``attempted``,
``failed``, ``metrics``, ``device``; with ``--trace 1`` also
``breakdown``; ``checks`` last); the last lines of standard error are the
compared numbers beside their limits.

``--controls fp8,half_batch`` (calibration only) also runs the f32
reference's control in float8 and the half-batch fault in the program's
place, reports each one's numbers and verdict against the same
reference and limits, and fails the run, printing no result, when a
control comes out correct.

Exits non-zero, printing no result, without a CUDA device or with fewer
than the cell asks for, and when JAX, flax or the JAX package were
loaded into the process by the time the window closed, and (4) when a
control comes out correct.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

PERFBENCH = Path(__file__).resolve().parent
ROOT = PERFBENCH.parent
CACHE = ROOT / ".perfbench_cache"
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def _set_environment() -> None:
    """Build and kernel caches at fixed paths inside the checkout, before
    anything imports torch or triton."""
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ.setdefault("TOKENIZERS_PARALLELISM", "false")
    for p in (str(PERFBENCH), str(ROOT / "src")):
        if p not in sys.path:
            sys.path.insert(0, p)


def loaded_forbidden() -> list:
    """Top-level names of loaded modules that are JAX's or the JAX
    package's, compared whole (``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def _check_modules() -> None:
    found = loaded_forbidden()
    if found:
        print(f"perfbench: modules {found} were loaded into the process "
              "that measures", file=sys.stderr)
        sys.exit(3)


def _log(msg: str) -> None:
    print(f"perfbench: {msg}", file=sys.stderr, flush=True)


def _parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--controls", default="")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = _parse(argv)
    _set_environment()
    from harness import report, spec

    bench = spec.benchmark(ROOT)
    cell = spec.cell(bench, args.workload)
    import torch
    if not torch.cuda.is_available():
        _log("no CUDA device: nothing measured")
        return 2
    if torch.cuda.device_count() < int(cell["chips"]):
        _log(f"the cell asks for {cell['chips']} devices, "
             f"{torch.cuda.device_count()} present: nothing measured")
        return 2
    ctx = report.context(bench, cell, args, device=torch.device("cuda", 0),
                         t_start=T_START, log=_log,
                         check_modules=_check_modules)
    result, checks = report.run_cell(ctx)
    _check_modules()
    passed = report.controls_passed(result)
    if passed:
        report.emit_controls(result)
        _log(f"controls {passed} came out correct: the limits cannot "
             "tell them from the program")
        return 4
    report.emit(result, checks)
    return 0


if __name__ == "__main__":
    sys.exit(main())
