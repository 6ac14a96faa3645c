"""The cheap golden rows of the assembled (FA) path and of `-bt 1`, run to
the end by remhos_torch.driver.run in f64 on the CPU:
`remap-cube3d-m5` (-ho 3 -lo 1 -fct 1), `remap-cube3d-m1` (-ho 1 -lo 2
-fct 2), `readme-run11-cube3d` (-ho 1 -lo 4, a mesh that tangles late in
the pseudo-time), `sharpen-pacman-autodt` (-ho 3 -lo 5 -fct 4 -bt 1 -dtc 1
from the CFL dt) and `transport-cube-m1`. Held by the golden runner's own
check (`remhos_torch.tools.run_goldens.check_row`): 5e-10 relative on the
final mass and on max u where the row has one (the baseline prints 10
significant digits), the mass loss within [0.1, 10] of the row's where it
has one."""

import json
from pathlib import Path

import pytest

from remhos_torch import driver
from remhos_torch.config import RunConfig
from remhos_torch.tools.run_goldens import check_row
from torch_threads import one_torch_thread  # noqa: F401

ROWS = ("remap-cube3d-m5", "remap-cube3d-m1", "readme-run11-cube3d",
        "sharpen-pacman-autodt", "transport-cube-m1")
GOLDENS = Path(__file__).resolve().parents[1] / "goldens" / \
    "reference_goldens.json"


def _rel_close(a, b, tol):
    return abs(a - b) <= tol * max(abs(a), abs(b), 1e-30)


@pytest.mark.parametrize("name", ROWS)
def test_golden_row(name):
    row = next(r for r in json.loads(GOLDENS.read_text())["runs"]
               if r["name"] == name)
    cfg = row["cfg"]
    assert not cfg.get("pa")
    res = driver.run(RunConfig(verbose=False, device="cpu", **cfg))
    assert check_row(row, res, False) == []
    assert _rel_close(res.final_mass_u, row["mass"], 5e-10)
    assert res.steps == res.steps_total or cfg.get("dt_control")
    if row["cfg"]["problem"] >= 10:
        assert res.t >= 1.0 - 1e-8
