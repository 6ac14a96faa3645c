"""Two golden rows of the tenth slice, run to the end by
remhos_torch.driver.run in f64 on the CPU: `transport-1d-m2` (1D, -ho 3
-lo 4 -fct 2, 1000 steps, ~3 s) and `steady-mono1` (-mono 1 -si 1 on
problem 6, run to the steady state, 1785 steps, ~17 s). Held by the golden
runner's own check (`remhos_torch.tools.run_goldens.check_row`): 5e-10
relative on the final mass and on max u (the baseline prints 10
significant digits). The other five rows of the slice run on the card
(chip_smoke.py)."""

import json
from pathlib import Path

import pytest

from remhos_torch import driver
from remhos_torch.config import RunConfig
from remhos_torch.tools.run_goldens import check_row
from torch_threads import one_torch_thread  # noqa: F401

GOLDENS = Path(__file__).resolve().parents[1] / "goldens" / \
    "reference_goldens.json"


@pytest.mark.parametrize("name", ["transport-1d-m2", "steady-mono1"])
def test_golden_row(name):
    row = next(r for r in json.loads(GOLDENS.read_text())["runs"]
               if r["name"] == name)
    cfg = row["cfg"]
    res = driver.run(RunConfig(verbose=False, device="cpu", **cfg))
    assert check_row(row, res, False) == []
    assert abs(res.final_mass_u - row["mass"]) <= 5e-10 * row["mass"]
    assert abs(res.max_u - row["max"]) <= 5e-10 * row["max"]
