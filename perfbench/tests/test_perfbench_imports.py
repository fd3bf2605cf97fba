"""What the benchmark's modules import: nothing of JAX or the JAX
package anywhere (top-level names compared whole: ``repro_torch`` is not
``repro``), and nothing of the program in the reference."""
import ast
from pathlib import Path

import pytest

PERFBENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


SOURCES = sorted(PERFBENCH.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(
    PERFBENCH)))
def test_no_jax_anywhere(path):
    assert not set(_imports(path)) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((PERFBENCH / "reference")
                                        .rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert set(_imports(path)) <= {"__future__", "math", "typing", "torch"}


def test_the_runtime_check_compares_whole_names(monkeypatch):
    import sys
    import types

    import run
    monkeypatch.setitem(sys.modules, "repro_torch_lookalike",
                        types.ModuleType("repro_torch_lookalike"))
    assert run.loaded_forbidden() == []
    monkeypatch.setitem(sys.modules, "repro.io", types.ModuleType("repro.io"))
    assert run.loaded_forbidden() == ["repro"]
