"""The four remap `-pa` rows of goldens/reference_goldens.json outside the
`-lo 5` family, run to the end by remhos_torch.driver.run in f64 on the CPU:
`-ho 2 -lo 3|4 -fct 2 -pa` on the 3D cube (50 steps) and on the 2D pacman
problem (667 steps). Tolerance: 5e-10 relative on the final mass and on
max u, as in tools/run_goldens.py (the baseline prints 10 significant
digits)."""

import json
from pathlib import Path

import pytest

from remhos_torch import driver
from remhos_torch.config import RunConfig

ROWS = ("remap-cube3d-m3pa", "remap-cube3d-m4pa", "remap-pacman-m3pa",
        "remap-pacman-m4pa")
GOLDENS = Path(__file__).resolve().parents[1] / "goldens" / \
    "reference_goldens.json"


def _rel_close(a, b, tol):
    return abs(a - b) <= tol * max(abs(a), abs(b), 1e-30)


@pytest.mark.parametrize("name", ROWS)
def test_golden_row(name):
    row = next(r for r in json.loads(GOLDENS.read_text())["runs"]
               if r["name"] == name)
    cfg = row["cfg"]
    assert cfg["pa"] and cfg["ho"] == 2 and cfg["lo"] in (3, 4)
    res = driver.run(RunConfig(verbose=False, device="cpu", **cfg))
    assert _rel_close(res.final_mass_u, row["mass"], 5e-10)
    assert _rel_close(res.max_u, row["max"], 5e-10)
    assert res.t >= 1.0 - 1e-8 and res.steps == res.steps_total
