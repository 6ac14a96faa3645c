"""The four transport `-pa` rows of goldens/reference_goldens.json, run to
the end by remhos_torch.driver.run in f64 on the CPU: `-ho 2 -lo 3|4 -fct 2
-pa` for balls and jacks (problem 5) on periodic-square refined three times
(200 steps to t = 0.8) and for problem 0 on periodic-cube refined once, p=2
(134 steps to t = 2). Tolerance: 5e-10 relative on the final mass and on
max u, as in tools/run_goldens.py (the baseline prints 10 significant
digits). The remap rows are in tests/test_torch_pa_goldens.py."""

import json
from pathlib import Path

import pytest

from remhos_torch import driver
from remhos_torch.config import RunConfig
from torch_threads import one_torch_thread  # noqa: F401

ROWS = ("transport-ballsjacks-m3pa", "transport-ballsjacks-m4pa",
        "transport-cube-m3pa", "transport-cube-m4pa")
GOLDENS = Path(__file__).resolve().parents[1] / "goldens" / \
    "reference_goldens.json"


def _rel_close(a, b, tol):
    return abs(a - b) <= tol * max(abs(a), abs(b), 1e-30)


@pytest.mark.parametrize("name", ROWS)
def test_golden_row(name):
    row = next(r for r in json.loads(GOLDENS.read_text())["runs"]
               if r["name"] == name)
    cfg = row["cfg"]
    assert cfg["pa"] and cfg["problem"] < 10 and cfg["lo"] in (3, 4)
    res = driver.run(RunConfig(verbose=False, device="cpu", **cfg))
    assert _rel_close(res.final_mass_u, row["mass"], 5e-10)
    assert _rel_close(res.max_u, row["max"], 5e-10)
    assert res.t >= cfg["t_final"] - 1e-8 and res.steps == res.steps_total
    # one Bernstein CG solve for each stage's HO solution
    assert res.cg_solves == 3 * res.steps
