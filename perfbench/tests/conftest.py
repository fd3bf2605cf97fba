"""The benchmark's own tests (not collected by the repository's suite):

    python -m pytest -q perfbench/tests

They import the harness as ``perfbench/run.py`` does: ``perfbench/`` and
``src/`` on the path."""
import sys
from pathlib import Path

_HERE = Path(__file__).resolve().parents[1]
for p in (str(_HERE), str(_HERE.parent / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)
