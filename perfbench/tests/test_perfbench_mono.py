"""The monolithic transport cell (`transport-mono1-si2-o1.n2048`) on the CPU
at 8^2: its result line and the faults `correct` has to catch, the float32
control seen to come out not correct, the reference's refusals, a hand
count of its yardstick, and its two per-layer readers on a traced CPU run.

The small cell keeps the configuration and the cell's Courant number (dt
1.5625e-4 x 2048 / 8)."""

import time

import pytest
import torch

from perfbench import harness, tracing
from perfbench import traffic as trf
from perfbench import yardstick_mono as ym
from perfbench.reference import transport_mono as ref
from perfbench.yardstick import Sizes

CELL = "transport-mono1-si2-o1.n2048"
SEED = 2 ** 31 + 2323


def small():
    cell = harness.Cell(CELL)
    cell.traffic.update(n=8, dt=cell.traffic["dt"] * cell.traffic["n"] / 8)
    return cell


def run(cell, build=None, seconds=1.0):
    return harness.run(cell, SEED, seconds, False, time.perf_counter(),
                       device="cpu", build=build)


def test_result_line():
    cell = small()
    res = run(cell)
    assert res["correct"] is True and res["failed"] == 0
    assert set(res["checks"]) == {"u_max_gap", "u_mass_ref_gap"}
    for v in res["checks"].values():
        assert v["value"] <= v["limit"]
    e2e = {m["name"] for m in cell.metrics["end_to_end"]}
    assert set(res["metrics"]) == e2e - {"peak_mem_gib"}          # CPU
    assert {m["name"] for m in cell.metrics["per_layer"]} == {
        "mono_stage_roofline", "launches_per_stage",
        "glue_device_us_per_stage", "device_idle_pct"}


def _fault(kind):
    """A build whose phase's u is altered where it is produced: one dof by
    1e-6 ("altered"), every dof lowered by 1e-6 ("shifted"), the largest
    dof raised by 0.2 ("overshoot"), the state left as it started
    ("unchanged")."""
    def build(config, traffic, S0, device):
        entry = harness.module_at(harness.HERE / "entries"
                                  / f"{config['entry']}.py").build(
            config, traffic, S0, device)
        phase = entry.phase

        def altered():
            S, mass = phase()
            u = S[0]
            if kind == "altered":
                u.view(-1)[7] += 1e-6
            elif kind == "shifted":
                u -= 1e-6
            elif kind == "overshoot":
                u.view(-1)[int(u.argmax())] += 0.2
            else:
                S = entry.S0.clone()
            return S, mass
        entry.phase = altered
        return entry
    return build


@pytest.mark.parametrize("kind", ["altered", "shifted", "overshoot",
                                  "unchanged"])
def test_faults_are_not_correct(kind):
    res = run(small(), build=_fault(kind))
    assert res["correct"] is False and res["failed"] >= 1
    if kind == "overshoot":
        gap = res["checks"]["u_max_gap"]
        assert gap["value"] > gap["limit"]


class _Control:
    """The reference computed in float32, in the program's place."""

    def __init__(self, cell, S0):
        self.ref = ref.Reference(cell.config, cell.traffic, "cpu",
                                 dtype=torch.float32)
        self.S0 = S0

    def phase(self):
        return self.ref.phase(self.S0)

    @staticmethod
    def state(result):
        return result.double()

    def counters(self):
        return {}


def test_the_control_is_not_correct():
    cell = small()
    res = run(cell, build=lambda c, t, S0, d: _Control(cell, S0))
    assert res["correct"] is False and res["attempted"] >= 1
    assert res["checks"]["u_max_gap"]["value"] > \
        res["checks"]["u_max_gap"]["limit"]


@pytest.mark.parametrize("key,value", [("problem", 6), ("mono", 2),
                                       ("smth_ind", 1), ("pa", True),
                                       ("product_sync", True),
                                       ("bounds_type", 1),
                                       ("ode_solver", 4), ("order", 2)])
def test_the_reference_refuses_what_it_does_not_compute(key, value):
    cell = harness.Cell(CELL)
    if key == "order":
        cell.config["order"] = value
    else:
        cell.config["solver"][key] = value
    with pytest.raises(ValueError):
        ref.points(cell.config, cell.traffic, "cpu")
    with pytest.raises(ValueError):
        ref.Reference(cell.config, cell.traffic, "cpu")


def test_the_entry_takes_only_inline_quad_refinements():
    cell = small()
    cell.traffic["n"] = 12
    S0 = torch.zeros(1, 144, 4, dtype=torch.float64)
    with pytest.raises(ValueError):
        harness.module_at(harness.HERE / "entries"
                          / "driver_steps_mono.py").build(
            cell.config, cell.traffic, S0, "cpu")


def test_yardstick_by_hand():
    """p=1 on 4^2 elements in float64, mesh order 2: D=2, nd=4, fd=2, nf=4,
    the rule Q1=3 (Q=9, Qf=3), mesh nodes m1=3 (nm=9)."""
    s = Sizes(4, 1, dim=2, mesh_order=2, itemsize=8)
    # the gradients of a 3^2 node field at 3^2 points, axis by axis with
    # shared partials (2 x 3 x 3 x 3 + 2 x 9 x 3), and one interpolation (3
    # x 3 x 3 + 9 x 3), each for 2 components; on a face 3 -> 3: 9 and 9
    grad, interp = 54 + 54, 27 + 27
    face_grad, face_interp = 9, 9
    # one element matrix on the 3^2 rule: 3^2 x 2^2 + 3 x 2^4; on the face
    # rule 3 x 2^2; ml: 3 x 2 x 2 + 9 x 2 (from the 2^2 dofs to the points)
    mat, face_mat, ml = 36 + 48, 12, 12 + 18
    mass = 2 * 16 + 4
    want = dict(
        geometry=2 * 2 * (grad + interp) + 17 * 9,
        faces=4 * (2 * 2 * (face_grad + face_interp) + 8 * 3),
        matrices=2 * (3 * mat + 4 * face_mat + ml),
        bounds=2 * 4 + 2 * 8,
        si=mass + 2 * (mass + 6) + mass + 16 + 10 + 4,
        mono=2 * 16 + 43 * 4,
        lumping=4 * (2 * 4 + 16 * 2),
        rd=15 * 4 + 6,
        combine=5 * 4)
    assert ym.mono_stage_parts(s) == pytest.approx(want)
    nbytes, flops = ym.mono_stage(s)
    assert nbytes == (16 * (9 * 2 + 2 * 4) + 4 * 4 * 2) * 8
    assert flops == pytest.approx(16 * sum(want.values()))
    assert ym.least_stage_seconds(s) == pytest.approx(
        max(nbytes / 3.35e12, flops / 67e12))


def _cpu_trace(cell):
    """The cell's two traced phases on the CPU, as the harness marks them,
    with every `aten::` op standing in for a device event of the same
    interval (a CPU has no device trace)."""
    from remhos_torch.utils import trace as trc
    c, t = cell.config, cell.traffic
    S0 = trf.initial_fields(ref.points(c, t, "cpu"), t, SEED)
    entry = harness.module_at(harness.HERE / "entries"
                              / f"{c['entry']}.py").build(c, t, S0, "cpu")

    def fn():
        for _ in range(cell.cell["trace_phases"]):
            with torch.profiler.record_function(tracing.PHASE_SPAN):
                entry.phase()
    raw = trc.capture_trace(fn)
    ev = [dict(e, cat="kernel") if e.get("cat") == "cpu_op"
          and str(e.get("name")).startswith("aten::") else e
          for e in raw["traceEvents"]]
    return tracing.Trace({"traceEvents": ev}, ())


def test_per_layer_readers_on_a_cpu_trace():
    cell = small()
    tr = _cpu_trace(cell)
    stages = 3 * cell.steps * cell.cell["trace_phases"]
    ctx = dict(cell=cell, trace=tr, stages=stages, sizes=cell.sizes())
    read = {name: harness.module_at(harness.HERE / "metrics"
                                    / f"{name}.py").read
            for name in ("mono_stage_roofline", "launches_per_stage")}
    roof = read["mono_stage_roofline"](ctx)
    assert 0 < roof <= 100
    assert roof == pytest.approx(
        100 * ym.least_stage_seconds(cell.sizes()) / (tr.busy_s() / stages))
    assert read["launches_per_stage"](ctx) == len(tr.events) / stages
    empty = dict(ctx, trace=tracing.Trace({"traceEvents": []}, ()))
    assert all(r(empty) is None for r in read.values())
    assert all(r(dict(ctx, trace=None)) is None for r in read.values())
