"""The program's spans (`utils/trace.py`).

- The span reading on small synthetic Chrome traces: device time by the
  innermost span around the launching runtime call, idle time by the
  innermost span open on the spans' thread, idle time inside one span, and
  a span's host time less its waits.
- One RK3 step of the main path's solver set (`-ho 3 -lo 5 -fct 2 -pa`,
  the fused stage, `bench.run_steps` with its closures) and of the
  non-fused product remap's (`-ho 3 -lo 3 -fct 2 -pa -ps`, the full closure
  after the step, as `driver.run` steps it) at 4^3, p=3, and of the
  assembled remap's (`-ho 3 -lo 1|2 -fct 1`, float64) at 4^3, p=2, on the
  CPU, under `capture_trace`: how the spans nest, that the `remhos.sync`
  spans are the host waits the solvers and closures make, that nothing
  records without a profiler, and that the state is bit for bit the same
  with and without one.
- `gpu` tests (they skip without a card): the same steps at 8^3 on the
  card, where each `remhos.sync` span must end after the device work it
  waited for (the spans and the device events share one clock) and the
  `remhos.sync` spans must equal the runtime's synchronizing calls.

This file imports neither jax nor remhos_tpu:
    python -m pytest tests/test_torch_spans.py -m gpu --noconftest
"""

from collections import Counter

import pytest
import torch

from remhos_torch import bench
from remhos_torch import steppers as st
from remhos_torch.discretization import build_discretization
from remhos_torch.driver import integrate_mesh_velocity
from remhos_torch.geometry import lumped_mass_poly
from remhos_torch.mesh import make_cartesian_mesh
from remhos_torch.operator import Advection, SolverConfig
from remhos_torch.utils import trace as trc

from torch_threads import one_torch_thread  # noqa: F401

F32, F64 = torch.float32, torch.float64
# the program's spans, from the launch path down to the solver, and the span
# of every host wait
SPANS = ("remhos.step", "remhos.stage", "remhos.closure", "remhos.geometry",
         "remhos.assemble", "remhos.factor", "remhos.upwind",
         "remhos.gather", "remhos.bounds", "remhos.ho", "remhos.cg",
         "remhos.lo", "remhos.fct", "remhos.flux", "remhos.product",
         "remhos.sync")
# the runtime calls with which the host waits for the device
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaMemcpy")


def _ev(cat, name, ts, dur, tid=1, **args):
    return dict(ph="X", cat=cat, name=name, ts=ts, dur=dur, pid=1, tid=tid,
                args=args)


def _synthetic():
    """A stage with a nested CG and its wait, then a closure; a copy
    launched outside every span; the device on its own thread (7)."""
    return {"traceEvents": [
        _ev("user_annotation", "remhos.stage", 0, 100),
        _ev("user_annotation", "remhos.cg", 10, 50),
        _ev("user_annotation", "remhos.sync", 40, 15),
        _ev("user_annotation", "remhos.closure", 120, 20),
        _ev("user_annotation", "other.span", 120, 20),
        _ev("cpu_op", "aten::mul", 2, 4),
        _ev("cuda_runtime", "cudaLaunchKernel", 3, 1, correlation=1),
        _ev("cuda_runtime", "cudaLaunchKernel", 20, 1, correlation=2),
        _ev("cuda_runtime", "cudaMemcpyAsync", 41, 1, correlation=3),
        _ev("cuda_runtime", "cudaStreamSynchronize", 43, 11),
        _ev("cuda_runtime", "cudaLaunchKernel", 80, 1, correlation=4),
        _ev("cuda_runtime", "cudaMemcpyAsync", 110, 1, correlation=5),
        _ev("cuda_runtime", "cudaLaunchKernel", 125, 1, correlation=6),
        _ev("kernel", "elementwise_kernel<float>", 5, 10, tid=7,
            correlation=1),
        _ev("kernel", "gemm_f32", 25, 20, tid=7, correlation=2),
        _ev("gpu_memcpy", "Memcpy DtoH", 50, 2, tid=7, correlation=3),
        _ev("kernel", "reduce_kernel", 90, 20, tid=7, correlation=4),
        _ev("gpu_memcpy", "Memcpy HtoD", 112, 3, tid=7, correlation=5),
        _ev("kernel", "dot_kernel", 130, 4, tid=7, correlation=6),
    ]}


def test_device_time_by_span():
    """Each device event goes to the innermost program span around its
    launch; the copy launched outside every span goes to OUTSIDE, and a
    span of another name does not count."""
    acc = trc.device_by_span(_synthetic())
    assert acc == pytest.approx({"remhos.stage": 30e-6, "remhos.cg": 20e-6,
                                 "remhos.sync": 2e-6, trc.OUTSIDE: 3e-6,
                                 "remhos.closure": 4e-6})


def test_idle_time_by_span():
    """The loop's window is 0-140. Idle: 0-5 (stage), 15-25 (cg), 45-50
    (sync), 52-90 (a gap across three spans: sync to 55, cg to 60, stage),
    110-112 (outside), 115-130 (outside to 120, then closure), 134-140
    (closure)."""
    tr = _synthetic()
    assert trc.loop_window(tr) == (0.0, 140.0)
    acc = trc.idle_by_span(tr)
    assert acc == pytest.approx({"remhos.stage": 35e-6, "remhos.cg": 15e-6,
                                 "remhos.sync": 8e-6, trc.OUTSIDE: 7e-6,
                                 "remhos.closure": 16e-6})
    # a window of its own: 50-100
    assert trc.idle_by_span(tr, (50.0, 100.0)) == pytest.approx(
        {"remhos.sync": 3e-6, "remhos.cg": 5e-6, "remhos.stage": 30e-6})


def test_host_time_of_spans():
    """A stage's host time leaves out the waits inside it."""
    tr = _synthetic()
    assert trc.host_s_of_spans(tr) == pytest.approx([85e-6])
    assert trc.host_s_of_spans(tr, "remhos.closure") == pytest.approx(
        [20e-6])
    rep = trc.loop_report(tr, n_calls=1, stages_per_call=1)
    assert rep["host_syncs_per_call"] == 1
    assert rep["host_s_per_stage"] == pytest.approx(85e-6)
    assert list(rep["device_s_per_stage_by_span"])[0] == "remhos.stage"


def test_nested_spans_give_the_innermost_stretches():
    segs = trc._innermost_segments([(0, 10, "a"), (2, 5, "b"), (3, 4, "c"),
                                    (6, 8, "d"), (12, 14, "e")])
    assert segs == [(0, 2, "a"), (2, 3, "b"), (3, 4, "c"), (4, 5, "b"),
                    (5, 6, "a"), (6, 8, "d"), (8, 10, "a"), (12, 14, "e")]


def test_span_is_a_shared_no_op_without_a_profiler():
    """With no profiler recording, every span is the one shared no-op
    object, and a host wait returns what its read returns."""
    assert not trc._recording()
    assert trc.span("remhos.stage") is trc.span("remhos.cg")
    assert trc.host_wait(bool, torch.tensor(1.0) > 0) is True
    assert trc.host_wait(float, torch.tensor(2.5)) == 2.5


def _main_path(n, device):
    """The main path's one-step phase (`bench.run_steps`)."""
    case = bench.build_case(n=n, order=3, dtype=F32, device=device,
                            n_steps=1)
    return case, lambda: bench.run_steps(case, 1)[:2]


def _product_remap(n, device, dt=0.005):
    """The non-fused product remap's step and full closure, as
    `driver.run`'s loop steps them, from a seeded u (zero in a third of
    the elements) and us = u s."""
    mesh = make_cartesian_mesh(3, (n,) * 3, (0.0,) * 3, (1.0,) * 3,
                               (False,) * 3)
    disc = build_discretization(mesh, 3)
    cfg = SolverConfig(problem=10, ho=3, lo=3, fct=2, ode_solver=3, pa=True,
                       product_sync=True)
    x0 = torch.as_tensor(mesh.x, dtype=F64, device=device)
    v = integrate_mesh_velocity(x0, cfg.problem, mesh.bb_min, mesh.bb_max,
                                0.7, dt)
    x32, v32 = x0.to(F32), v.to(F32)
    adv = Advection(disc, cfg, x32, v32, dtype=F32, device=device)
    step = st.make_rk_step(adv.stage_function(), 3, compensated=True)
    mlk, sig = lumped_mass_poly(x32, v32, disc)
    mlk = mlk.to(F32)
    g = torch.Generator().manual_seed(11)
    E, nd = mlk.shape[1:]
    u = torch.rand((E, nd), generator=g, dtype=F32)
    u = u * (torch.arange(E) % 3 != 0)[:, None]
    s = 0.5 + torch.rand((E, nd), generator=g, dtype=F32)
    S0 = torch.stack([u, u * s]).to(device)
    m0 = float(mlk[0].to(F64).reshape(-1) @ S0[0].to(F64).reshape(-1))
    closure = st.make_mass_closure(mlk, sig.cpu().numpy(), m0)

    def phase():
        S, C, _ = step(S0, torch.zeros_like(S0), 0.0, dt)
        C[0] = closure(S[0], C[0], dt)[0]
        return S, C
    return adv, phase


def _assembled(n, device, lo=1, dt=0.02):
    """The phase of one RK3 step of the assembled remap (`-ho 3 -lo 1|2
    -fct 1`, float64: the plain combine, no closure, as `driver.run` steps
    it) from a seeded u."""
    mesh = make_cartesian_mesh(3, (n,) * 3, (0.0,) * 3, (1.0,) * 3,
                               (False,) * 3)
    disc = build_discretization(mesh, 2)
    cfg = SolverConfig(problem=10, ho=3, lo=lo, fct=1, ode_solver=3,
                       pa=False)
    x0 = torch.as_tensor(mesh.x, dtype=F64, device=device)
    v = integrate_mesh_velocity(x0, cfg.problem, mesh.bb_min, mesh.bb_max,
                                0.7, dt)
    adv = Advection(disc, cfg, x0, v, dtype=F64, device=device)
    step = st.make_rk_step(adv.stage_function(), 3)
    g = torch.Generator().manual_seed(13)
    u = torch.rand((n ** 3, disc.nd), generator=g, dtype=F64).to(device)
    return lambda: step(u[None], 0.0, dt)[0]


def _traced(phase, stats=None):
    """(trace, state, CG solves and iterations) of the recorded run of
    phase() under `capture_trace`, its body in a `test.phase` span."""
    out = {}

    def fn():
        s0 = dict(stats or {})
        with torch.profiler.record_function("test.phase"):
            out["state"] = phase()
        out["cg"] = {k: stats[k] - s0.get(k, 0) for k in stats or {}}
    tr = trc.capture_trace(fn)
    return tr, out["state"], out["cg"]


def _parent(spans, child):
    """The innermost span that holds `child` ((ts, end, name, thread))."""
    a, b, _, key = child
    holders = [s for s in spans if s[3] == key and s[0] <= a and b <= s[1]
               and s is not child]
    return max(holders, key=lambda s: s[0])[2] if holders else None


def _check_nesting(spans):
    """Every stage in a step, three to a step (RK3)."""
    names = Counter(n for *_, n, _ in spans)
    assert names["remhos.stage"] == 3 * names["remhos.step"] > 0
    for s in spans:
        if s[2] == "remhos.stage":
            assert _parent(spans, s) == "remhos.step"
    assert set(names) <= set(SPANS)
    return names


def test_main_path_spans_on_the_cpu():
    """The fused stage: bounds and the gather inside each stage; the
    incremental closure a step and the full one at the end; five host
    waits (three coefficient copies, the full closure's copy, the
    injected mass's read-back), each a span; nothing recorded in the
    capture's warm-up cycle."""
    case, phase = _main_path(4, "cpu")
    ref = phase()
    tr, state, _ = _traced(phase)
    spans = trc.program_spans(tr)
    names = _check_nesting(spans)
    assert names["remhos.step"] == 1
    assert names["remhos.closure"] == 2
    assert names["remhos.bounds"] == 2 * 3 and names["remhos.gather"] == 3
    assert names["remhos.sync"] == 5
    assert all(torch.equal(a, b) for a, b in zip(state, ref))


def test_product_remap_spans_on_the_cpu():
    """The non-fused product stage: HO > CG > sync, the LO, the bounds,
    FCT and the product sync in each stage; every CG test and the
    closure's copy is one `remhos.sync` span:
    waits = CG iterations + solves + closures."""
    adv, phase = _product_remap(4, "cpu")
    ref = phase()
    tr, state, cg = _traced(phase, adv.cg_stats)
    spans = trc.program_spans(tr)
    names = _check_nesting(spans)
    for s in spans:
        parent = _parent(spans, s)
        if s[2] in ("remhos.ho", "remhos.lo", "remhos.fct",
                    "remhos.product", "remhos.geometry"):
            assert parent == "remhos.stage", s
        if s[2] == "remhos.cg":
            assert parent == "remhos.ho"
        if s[2] == "remhos.sync":
            assert parent in ("remhos.cg", "remhos.closure")
    assert names["remhos.ho"] == names["remhos.cg"] == 6      # u and us
    for n in ("remhos.lo", "remhos.fct", "remhos.product",
              "remhos.geometry"):
        assert names[n] == 3, n
    assert names["remhos.bounds"] == 2 * 3                   # u, then s
    assert cg["solves"] == 6
    assert names["remhos.sync"] == \
        cg["iterations"] + cg["solves"] + names["remhos.closure"]
    assert all(torch.equal(a, b) for a, b in zip(state, ref))


@pytest.mark.parametrize("lo", [1, 2])
def test_assembled_spans_on_the_cpu(lo):
    """The assembled stage: the element assembly, the mass factorization
    and the discrete upwinding inside the stage's geometry, the flux blocks
    inside FCT, a stage each; the factorization's info read is a stage's
    one host wait (with `-lo 2` the preconditioned convection matrix's
    factorization is one more, inside the upwinding)."""
    phase = _assembled(4, "cpu", lo)
    ref = phase()
    tr, state, _ = _traced(phase)
    spans = trc.program_spans(tr)
    names = _check_nesting(spans)
    for s in spans:
        parent = _parent(spans, s)
        if s[2] in ("remhos.assemble", "remhos.factor", "remhos.upwind"):
            assert parent == "remhos.geometry", s
        if s[2] == "remhos.flux":
            assert parent == "remhos.fct"
        if s[2] == "remhos.sync":
            assert parent in ("remhos.factor", "remhos.upwind")
    for n in ("remhos.geometry", "remhos.assemble", "remhos.factor",
              "remhos.upwind", "remhos.ho", "remhos.lo", "remhos.fct",
              "remhos.flux"):
        assert names[n] == 3, n
    assert names["remhos.sync"] == 3 * lo
    assert torch.equal(state, ref)


def _on_card(tr):
    """(worst lead, sync calls in the phase, waits as spans): how far
    before the end of the device work it waited for each `remhos.sync`
    span ended (the latest end of a device event launched before the
    span's end), in microseconds; and the runtime's synchronizing calls
    inside the `test.phase` span."""
    ev = tr["traceEvents"]
    launched = {e["args"]["correlation"]: float(e["ts"]) for e in ev
                if e.get("ph") == "X"
                and e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "correlation" in e.get("args", {})}
    dev = [(launched[o["corr"]], o["ts"] + o["dur"])
           for o in trc.device_ops(tr) if o["corr"] in launched]
    waits = trc.program_spans(tr, "remhos.sync")
    worst = max(max([end for t, end in dev if t < b], default=b) - b
                for a, b, _, _ in waits)
    (w0, w1), = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                 for e in ev if e.get("name") == "test.phase"
                 and e.get("cat") == "user_annotation"]
    calls = sum(1 for e in ev if e.get("ph") == "X"
                and e.get("cat") == "cuda_runtime"
                and e.get("name") in SYNC_CALLS
                and w0 <= float(e["ts"]) <= w1)
    return worst, calls, len(waits)


@pytest.mark.gpu
@pytest.mark.parametrize("path", ["main", "product", "assembled"])
def test_waits_on_the_card(path):
    """Every `remhos.sync` span is one synchronizing runtime call (in the
    product remap one for each CG test and one for the closure, in the
    assembled remap the mass factorization's info read), and ends
    no earlier than 10 us before the device work it waited for; the state
    is bit for bit the one of an untraced run. The product remap's
    `index_add` sums in no fixed order on the card, so the states are
    compared under deterministic algorithms."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    if path == "main":
        stats, phase = {}, _main_path(8, "cuda")[1]
    elif path == "assembled":
        stats, phase = {}, _assembled(8, "cuda")
    else:
        adv, phase = _product_remap(8, "cuda")
        stats = adv.cg_stats
    phase()
    tr, _, cg = _traced(phase, stats)
    worst, calls, waits = _on_card(tr)
    print(f"{path}: {waits} waits, {calls} sync calls, worst lead "
          f"{worst:.2f} us")
    assert waits == calls
    if cg:
        assert waits == cg["iterations"] + cg["solves"] + 1
    assert worst <= 10.0
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        ref = phase()
        state = _traced(phase)[1]
    finally:
        torch.use_deterministic_algorithms(False)
    assert all(torch.equal(a, b) for a, b in zip(state, ref))
