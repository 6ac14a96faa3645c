"""The assembled cell (`remap-fa-ho3lo1fct1-p2.n64`) on the CPU at a small
size: its result line and the faults `correct` has to catch, the float32
control seen to come out not correct, the reference's refusals, a hand
count of its yardstick, and its two per-layer readers on a synthetic
trace.

The small cell keeps the configuration and takes 4^3 elements, 2 steps and
dt 1e-3: on so coarse a mesh the scheme's own O(dt^4) mass error at the
64^3 CFL dt (3e-8 at 4^3) reaches `u_mass_gap`'s limit, which is set for
64^3."""

import time

import pytest
import torch

from perfbench import harness, tracing
from perfbench import yardstick_fa as yf
from perfbench.reference import remap as ref_pa
from perfbench.reference import remap_fa as ref
from perfbench.yardstick import Sizes

CELL = "remap-fa-ho3lo1fct1-p2.n64"
SEED = 2 ** 31 + 4321


def small():
    cell = harness.Cell(CELL)
    cell.traffic.update(n=4, steps_per_remap=2, dt=1e-3)
    return cell


def run(cell, build=None, seconds=2.0):
    return harness.run(cell, SEED, seconds, False, time.perf_counter(),
                       device="cpu", build=build)


def test_result_line():
    cell = small()
    res = run(cell)
    assert res["correct"] is True and res["failed"] == 0
    for v in res["checks"].values():
        assert v["value"] <= v["limit"]
    e2e = {m["name"] for m in cell.metrics["end_to_end"]}
    assert set(res["metrics"]) == e2e - {"peak_mem_gib"}          # CPU
    assert {m["name"] for m in cell.metrics["per_layer"]} == {
        "fa_stage_roofline", "fa_factor_device_us_per_stage"}


def _fault(kind):
    """A build whose phase's u is altered where it is produced: one dof by
    1e-6 ("altered"), every dof lowered by 1e-6 ("shifted"), the largest
    dof set 1e-11 above the initial u's largest ("overshoot"), the state
    left as it started ("unchanged")."""
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
                u.view(-1)[int(u.argmax())] = float(entry.S0[0].max()) + 1e-11
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
        excess = res["checks"]["u_bounds_excess"]
        assert excess["value"] > excess["limit"]


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


@pytest.mark.parametrize("key,value", [("lo", 2), ("lo", 5), ("fct", 2),
                                       ("ho", 2), ("pa", True),
                                       ("product_sync", True),
                                       ("bounds_type", 1),
                                       ("ode_solver", 4), ("problem", 14)])
def test_the_reference_refuses_what_it_does_not_compute(key, value):
    cell = harness.Cell(CELL)
    cell.config["solver"][key] = value
    with pytest.raises(ValueError):
        ref.points(cell.config, cell.traffic, "cpu")
    with pytest.raises(ValueError):
        ref.Reference(cell.config, cell.traffic, "cpu")


def test_each_reference_refuses_the_others_configurations():
    fa = harness.Cell(CELL)
    pa = harness.Cell("remap-pa-ho3lo5-p3.n48")
    with pytest.raises(ValueError):
        ref_pa.points(fa.config, fa.traffic, "cpu")
    with pytest.raises(ValueError):
        ref.points(pa.config, pa.traffic, "cpu")


def test_yardstick_by_hand():
    """p=1 on 2^3 elements in float64: D=2, nd=8, fd=4, the rule Q1=4,
    mesh nodes m1=3 (nm=27)."""
    s = Sizes(2, 1, itemsize=8)
    # sum-factorized passes, one axis at a time: the gradients of a 3^3
    # node field at 4^3 points (216 + 432 + 576, the yardstick's gradient
    # count), one interpolation (4 points x 3^2 x 3 nodes, then 4^2 x 3 x
    # 3, then 4^3 x 3), each for 3 components; on a face 3^2 -> 4^2
    grad, interp = 216 + 432 + 576, 4 * 27 + 16 * 9 + 64 * 3
    face_grad, face_interp = 2 * 4 * 3 * 3 + 2 * 16 * 3, 4 * 9 + 16 * 3
    # one element matrix on the 4^3 rule: 4^3 x 2^2 + 4^2 x 2^4 + 4 x 2^6;
    # on the 4^2 face rule 4^2 x 2^2 + 4 x 2^4; ml: 4 x 8 + 16 x 4 + 64 x 2
    mat, face_mat, ml = 3 * 256, 128, 32 + 64 + 128
    want = dict(
        geometry=2 * 3 * (grad + interp) + 55 * 64,
        faces=6 * (2 * 3 * (face_grad + face_interp) + 17 * 16),
        matrices=2 * (4 * mat + 6 * face_mat + ml),
        factor=8 ** 3 / 3,
        ho=2 * 64 + 6 * (2 * 16 + 4) + 2 * 64,
        lo=8 * 64 + 6 * (16 + 8) + 8,
        bounds=2 * 8 + 2 * 26,
        flux=6 * 16 + 10 * 64,
        sweep=9 * 64 + 15 * 8,
        combine=4 * 8)
    assert yf.fa_stage_parts(s) == pytest.approx(want)
    nbytes, flops = yf.fa_stage(s)
    assert nbytes == 8 * (2 * 27 * 3 + 2 * 8) * 8
    assert flops == pytest.approx(8 * sum(want.values()))
    assert yf.least_stage_seconds(s) == pytest.approx(
        max(nbytes / 3.35e12, flops / 67e12))


def _trace():
    """Two traced phases of 150 us: a Cholesky's kernel (40 us) and its
    nested zeroing of the upper triangle (6 us), a triangular solve's (10
    us), a copy's in a nested op (4 us) and a product's (40 us), busy 100
    us; the readers take them over the 12 stages of the cell's two
    phases."""
    def ev(cat, name, ts, dur, **args):
        return dict(ph="X", cat=cat, name=name, ts=ts, dur=dur, pid=1,
                    tid=1 if cat != "kernel" else 7, args=args)
    return {"traceEvents": [
        ev("user_annotation", tracing.PHASE_SPAN, 0, 150),
        ev("user_annotation", tracing.PHASE_SPAN, 150, 150),
        ev("cpu_op", "aten::linalg_cholesky_ex", 1, 8),
        ev("cuda_runtime", "cudaLaunchKernel", 2, 1, correlation=1),
        ev("cpu_op", "aten::tril_", 4, 2),
        ev("cuda_runtime", "cudaLaunchKernel", 5, 1, correlation=4),
        ev("cpu_op", "aten::copy_", 6, 2),
        ev("cuda_runtime", "cudaLaunchKernel", 7, 1, correlation=5),
        ev("cpu_op", "aten::linalg_solve_triangular", 10, 5),
        ev("cuda_runtime", "cudaLaunchKernel", 11, 1, correlation=2),
        ev("cpu_op", "aten::mm", 20, 5),
        ev("cuda_runtime", "cudaLaunchKernel", 21, 1, correlation=3),
        ev("kernel", "potrf_batched", 100, 40, correlation=1),
        ev("kernel", "triu_tril_kernel", 140, 6, correlation=4),
        ev("kernel", "copy_kernel", 146, 4, correlation=5),
        ev("kernel", "trsm_batched", 150, 10, correlation=2),
        ev("kernel", "gemm", 160, 40, correlation=3),
    ]}


def test_per_layer_readers_on_a_trace():
    cell = harness.Cell(CELL)
    tr = tracing.Trace(_trace(), ())
    ctx = dict(cell=cell, trace=tr, stages=12, sizes=cell.sizes())
    read = {name: harness.module_at(harness.HERE / "metrics"
                                    / f"{name}.py").read
            for name in ("fa_stage_roofline",
                         "fa_factor_device_us_per_stage")}
    assert read["fa_factor_device_us_per_stage"](ctx) == pytest.approx(
        (40 + 6 + 10) / 12)
    busy = 100e-6
    assert read["fa_stage_roofline"](ctx) == pytest.approx(
        100 * yf.least_stage_seconds(cell.sizes()) / (busy / 12))
    empty = dict(ctx, trace=tracing.Trace({"traceEvents": []}, ()))
    assert all(r(empty) is None for r in read.values())
    assert all(r(dict(ctx, trace=None)) is None for r in read.values())
