"""The controls through the run's own path (``perfbench/run.py
--controls``): the reference itself put in the program's place and
computed in float8 (every matrix product's operands rounded to e4m3,
its gradients to e5m2), the precision below the configurations'
bfloat16, and the half-batch fault planted in that reference, each has
to come out not correct under the cell's limits, while the program's
run beside them is correct. On the card they are read at the cells' own
sizes; here at the SMOKE sizes of ``test_perfbench_run.py`` with more
rows."""
import pytest

from harness import report

from test_perfbench_run import CELLS, run_cell


@pytest.mark.parametrize("cell", CELLS)
def test_controls_are_not_correct(cell):
    result, _ = run_cell(cell, "float32", seed=11,
                         controls="fp8,half_batch",
                         mix={"micro_batches": 8, "seq_len": 128})
    assert result["correct"], result["checks"]
    assert set(result["controls"]) == {"fp8", "half_batch"}
    for name, c in result["controls"].items():
        assert not c["correct"], (name, c["checks"])
    assert report.controls_passed(result) == []
    assert list(result)[-1] == "checks"
