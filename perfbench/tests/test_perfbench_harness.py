"""A whole run on the CPU at a small size: the result line's schema, the
faults `correct` has to catch, and the control (the reference in TF32 in
the program's place), each seen to come out not correct. The look for a
chip is the only part of a run skipped here."""

import json
import time

import pytest
import torch

from perfbench import harness
from perfbench import run as run_cli
from perfbench.reference import remap as ref

C1, C2 = "remap-pa-ho3lo5-p3.n48", "remap-pa-ho3lo3-ps-p3.n48"
SEED = 2 ** 31 + 12345


def small(name, n=3, steps=4):
    cell = harness.Cell(name)
    cell.traffic.update(n=n, steps_per_remap=steps)
    return cell


def run(cell, build=None, seconds=0.3):
    return harness.run(cell, SEED, seconds, False, time.perf_counter(),
                       device="cpu", build=build)


@pytest.mark.parametrize("name", [C1, C2])
def test_result_line(name):
    cell = small(name)
    res = run(cell)
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] >= 1
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(res)[-1] == "checks"
    assert set(res["checks"]) == set(cell.cell["limits"])
    for v in res["checks"].values():
        assert v["value"] <= v["limit"]
    e2e = {m["name"]: m["unit"] for m in cell.metrics["end_to_end"]}
    assert set(res["metrics"]) == set(e2e) - {"peak_mem_gib"}   # CPU
    for k, m in res["metrics"].items():
        assert m["unit"] == e2e[k] and m["value"] > 0
    assert set(res["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    json.dumps(res, allow_nan=False)


def test_no_card_no_result(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert run_cli.main(["--workload", C1, "--seed", "1", "--seconds", "1",
                         "--trace", "0"]) == 2
    assert capsys.readouterr().out == ""


def _stage_fault(monkeypatch, kind):
    """Break the program's stage function underneath the timed path."""
    from remhos_torch.operator import Advection
    orig = Advection.stage_function

    def stage_function(self):
        f = orig(self)

        def g(t, dt, S):
            dS, aux = f(t, dt, S)
            if kind == "unchanged":
                dS = torch.zeros_like(dS)
            elif kind == "nan":
                dS = dS.clone()
                dS[0, 0, 0] = float("nan")
            elif kind == "half":
                dS = dS.clone()
                dS[:, : dS.shape[1] // 2] = 0.0
            return dS, aux
        return g
    monkeypatch.setattr(Advection, "stage_function", stage_function)


def _answer_fault(kind):
    """A build whose phase's answer is altered where it is produced: one dof
    of u by 0.01 ("altered"); every dof of u lowered by 1e-4, a loss of
    mass and a dip below 0 that u_max_gap's limit lets pass ("shifted");
    the largest dof of u raised by 5e-4, over its bounds and again within
    u_max_gap's limit ("overshoot")."""
    def build(config, traffic, S0, device):
        entry = harness.module_at(harness.HERE / "entries"
                                  / f"{config['entry']}.py").build(
            config, traffic, S0, device)
        phase = entry.phase

        def altered():
            res = phase()
            u = res[0][0]
            if kind == "altered":
                u.view(-1)[7] += 0.01
            elif kind == "shifted":
                u -= 1e-4
            else:
                u.view(-1)[int(u.argmax())] += 5e-4
            return res
        entry.phase = altered
        return entry
    return build


ANSWER_FAULTS = ("altered", "shifted", "overshoot")


@pytest.mark.parametrize("name", [C1, C2])
@pytest.mark.parametrize("fault", ["unchanged", "half", "nan"]
                         + list(ANSWER_FAULTS))
def test_faults_are_not_correct(monkeypatch, name, fault):
    build = None
    if fault in ANSWER_FAULTS:
        build = _answer_fault(fault)
    else:
        _stage_fault(monkeypatch, fault)
    res = run(small(name), build=build)
    assert res["correct"] is False and res["failed"] >= 1
    if fault in ("shifted", "overshoot"):
        checks = res["checks"]
        assert checks["u_max_gap"]["value"] <= checks["u_max_gap"]["limit"]


class _Control:
    """The reference computed in float32 with TF32 products, in the
    program's place."""

    def __init__(self, cell, S0):
        self.ref = ref.Reference(cell.config, cell.traffic, "cpu",
                                 dtype=torch.float32, tf32=True)
        self.S0 = S0

    def phase(self):
        return self.ref.phase(self.S0)

    @staticmethod
    def state(result):
        return result.double()

    def counters(self):
        return {}


@pytest.mark.parametrize("name", [C1, C2])
def test_the_control_is_not_correct(name):
    cell = small(name, n=4, steps=8)
    res = run(cell, build=lambda c, t, S0, d: _Control(cell, S0),
              seconds=2.0)
    assert res["correct"] is False and res["attempted"] >= 1
    assert any(v["value"] > v["limit"] for v in res["checks"].values())


def test_cell_reads_its_files():
    cell = harness.Cell(C1)
    assert cell.sizes().itemsize == 4
    cell.config["dtype"] = "float64"
    assert cell.sizes().itemsize == 8
    assert cell.reference().Reference.__name__ == "Reference"


@pytest.mark.parametrize("key,value", [("lo", 1), ("problem", 14),
                                       ("fct", 1), ("ode_solver", 4)])
def test_the_reference_refuses_what_it_does_not_compute(key, value):
    cell = harness.Cell(C1)
    cell.config["solver"][key] = value
    with pytest.raises(ValueError):
        ref.points(cell.config, cell.traffic, "cpu")
