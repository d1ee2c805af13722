"""The control, the reference one precision below the configuration's put in
the program's place, fails the cell's comparison; the readings behind the
limits come from ``control.py`` on the card at the cell's own size, this
runs it at a size a test can hold."""
import pytest

import control
import spec
from tiny import tiny_cell

CELLS = [w["name"] for w in spec.load_json(spec.ROOT / "BENCHMARK.json")["workloads"]]


def _fails(numbers: dict, limits: dict) -> bool:
    return any(numbers[k] > lim for k, lim in limits.items())


@pytest.mark.parametrize("workload", CELLS)
def test_prefill_control_fails(workload):
    cell = tiny_cell(workload)
    row = control.readings(cell, 2**31 + 3, 0.3, True, "cpu")
    assert not _fails(row["program"], cell.limits), row
    assert _fails(row["control"], cell.limits), row

