"""The measurement entry points of remhos_torch on the CPU: the phase
ablation (utils/fom.py) against remhos_tpu's, the trace report
(utils/trace.py) on a hand-made event list, bench.run's phases and trace
options, and the two tools.

- each stage_prefix(level), levels 0-5, on a fused (-lo 5) and a non-fused
  (-lo 3) operator at 4^3, p=3, f64, against remhos_tpu.utils.fom's
  _make_stage_prefix on the same numpy inputs (the JAX operator with
  use_pallas, its kernels in interpret mode): <= 1e-12 relative;
- print_fom_report: the same dict and the same printed lines as the JAX
  function for fixed phase times;
- measure_phases on the CPU (host clock): its keys, and the phase deltas
  and level 0 adding up to the full stage;
- loop_report: the buckets, kernel counts and idle share of a known trace;
- bench.run's phases, trace and measure_steps options, and the two tools,
  at 2^3; tools/trace_drops.py, which on the CPU launches nothing.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from remhos_tpu.discretization import build_discretization as jbuild
from remhos_tpu.mesh import make_cartesian_mesh as jmesh
from remhos_tpu.operator import Advection as JAdvection
from remhos_tpu.operator import SolverConfig as JConfig
from remhos_tpu.utils import fom as jfom

from remhos_torch import bench, convert
from remhos_torch.discretization import build_discretization
from remhos_torch.mesh import make_cartesian_mesh
from remhos_torch.operator import Advection, SolverConfig
from remhos_torch.utils import fom, trace
from torch_threads import one_torch_thread  # noqa: F401

DT = 0.01
_OPS = {}


def _operators(lo):
    if lo in _OPS:
        return _OPS[lo]
    shape = (4, 4, 4)
    args = (3, shape, (0.0,) * 3, (1.0,) * 3, (False,) * 3)
    jd = jbuild(jmesh(*args), 3)
    td = build_discretization(make_cartesian_mesh(*args), 3)
    x0 = jd.mesh.x
    v = 0.1 * np.sin(x0)
    kw = dict(problem=10, ho=3, lo=lo, fct=2, pa=True)
    jadv = JAdvection(jd, JConfig(use_pallas=True, **kw), jnp.asarray(x0),
                      jnp.asarray(v), None)
    adv = Advection(td, SolverConfig(**kw), x0, v, dtype=torch.float64,
                    device="cpu")
    assert jadv._fused_stage == adv._fused_stage == (lo == 5)
    u = np.random.default_rng(lo).random((x0.shape[0], jd.nd))
    _OPS[lo] = (jadv, adv, u)
    return _OPS[lo]


@pytest.mark.parametrize("lo", [5, 3])
@pytest.mark.parametrize("level", range(6))
def test_stage_prefix_matches_jax(lo, level):
    jadv, adv, u = _operators(lo)
    dS_j, aux_j = jfom._make_stage_prefix(jadv, jnp.float64)(level)(
        jnp.asarray(0.1), DT, jnp.asarray(u)[None])
    dS_t, aux_t = fom._make_stage_prefix(adv, torch.float64)(level)(
        0.1, DT, convert.tensor(u)[None])
    dS_j = np.asarray(dS_j)
    assert tuple(dS_t.shape) == dS_j.shape == (1,) + u.shape
    scale = np.abs(dS_j).max()
    assert np.abs(dS_t.numpy() - dS_j).max() <= 1e-12 * scale
    if aux_t is not None:                  # the mega stage's is [inf, 0]
        np.testing.assert_array_equal(aux_t.numpy(), np.asarray(aux_j))


PHASES = dict(combine=2e-6, rhs=3e-4, inv=1e-4, lo=2e-5, bounds=1e-9,
              fct=4e-5, dispatch_per_call=1.5e-3, noise_floor=3e-6)


@pytest.mark.parametrize("total_wall", [None, 0.35])
@pytest.mark.parametrize("noise", [3e-6, 0.0])
def test_print_fom_report_matches_jax(capsys, total_wall, noise):
    ph = dict(PHASES, noise_floor=noise)
    want = jfom.print_fom_report(ph, 884736, 120, total_wall=total_wall)
    want_out = capsys.readouterr().out
    got = fom.print_fom_report(ph, 884736, 120, total_wall=total_wall)
    got_out = capsys.readouterr().out
    assert got == want
    assert got_out.splitlines() == want_out.splitlines()


def test_measure_phases_on_the_cpu():
    _, adv, u = _operators(5)
    ph = fom.measure_phases(adv, convert.tensor(u), DT, n_steps=2, reps=1,
                            device="cpu")
    for k in ("combine", "rhs", "inv", "lo", "bounds", "fct", "dispatch",
              "dispatch_per_call", "wall_total", "pipeline_total",
              "noise_floor"):
        assert np.isfinite(ph[k]), k
    assert ph["timing_source"] == "host_wall" and ph["device"] == "cpu"
    lv = ph["level_s_per_stage"]
    deltas = sum(ph[k] for k in ("rhs", "inv", "lo", "bounds", "fct"))
    assert abs(lv[0] + deltas - ph["pipeline_total"]) <= \
        1e-12 * ph["pipeline_total"]
    assert ph["pipeline_total"] == lv[5]
    with pytest.raises(ValueError, match="operator is on"):
        fom.measure_phases(adv, convert.tensor(u), DT, device="meta")


def _ev(cat, name, ts, dur, tid=1, **args):
    return dict(ph="X", cat=cat, name=name, ts=ts, dur=dur, pid=1, tid=tid,
                args=args)


def test_loop_report_on_a_known_trace():
    """Two aten ops launch glue kernels (one nested: the innermost op
    counts), a port kernel is launched outside any op, a copy by a bare
    runtime call; one kernel overlaps another on the device."""
    ev = [
        _ev("cpu_op", "aten::mul", 0, 10),
        _ev("cuda_runtime", "cudaLaunchKernel", 2, 1, correlation=1),
        _ev("cpu_op", "aten::matmul", 12, 18),
        _ev("cpu_op", "aten::mm", 13, 16),
        _ev("cuda_runtime", "cudaLaunchKernel", 14, 1, correlation=2),
        _ev("cuda_runtime", "cudaLaunchKernel", 40, 1, correlation=3),
        _ev("cuda_runtime", "cudaLaunchKernel", 41, 1, correlation=5),
        _ev("cuda_runtime", "cudaMemcpyAsync", 68, 1, correlation=4),
        _ev("kernel", "elementwise_kernel<float>", 20, 5, tid=7,
            correlation=1),
        _ev("kernel", "gemm_f32", 30, 10, tid=7, correlation=2),
        _ev("kernel", "void (anonymous namespace)::mega_stage_kernel<float,"
            " 3>((anonymous namespace)::Args<float, 3>)", 45, 20, tid=7,
            correlation=3),
        _ev("kernel", "void (anonymous namespace)::stage_ho_nodes_kernel<"
            "double, 2>(...)", 55, 4, tid=8, correlation=5),
        _ev("gpu_memcpy", "Memcpy DtoH", 80, 2, tid=7, correlation=4),
    ]
    rep = trace.loop_report({"traceEvents": ev}, n_calls=2,
                            stages_per_call=1)
    assert rep["kernel_calls"] == 2
    assert rep["kernel_calls_by_name"]["mega_stage"] == 1
    assert rep["kernel_calls_by_name"]["stage_ho_nodes"] == 1
    assert rep["kernel_calls_by_name"]["stage_ho"] == 0
    assert rep["kernel_s_per_stage"] == pytest.approx(12e-6)
    assert rep["glue_s_per_stage"] == pytest.approx(8.5e-6)
    assert list(rep["buckets_s_per_stage"]) == ["aten::mm", "aten::mul",
                                                "(gpu_memcpy)"]
    assert rep["buckets_s_per_stage"]["aten::mm"] == pytest.approx(5e-6)
    assert rep["busy_s"] == pytest.approx(37e-6)      # 59-65 lies in 45-65
    assert rep["wall_s"] == pytest.approx(82e-6)
    assert rep["idle_share"] == pytest.approx(1 - 37 / 82)
    assert trace.kernel_events({"traceEvents": ev})["mega_stage"] == 1
    assert trace.device_time_of_loop({"traceEvents": ev}) == \
        pytest.approx(41e-6)


def test_bench_run_options_on_the_cpu():
    case = bench.build_case(n=2, order=3, dtype=torch.float32, device="cpu",
                            n_steps=3)
    plain = bench.run(case)
    rec = bench.run(case, phases=True, trace=True)
    assert set(plain) < set(rec)
    for k in ("kernel_us_per_stage", "glue_us_per_stage",
              "glue_breakdown_us", "idle_share", "idle_share_untraced",
              "fom", "fom_rhs", "dispatch_ms_per_call",
              "hbm_bytes_per_stage_model", "device_us_per_stage_by_span",
              "idle_us_per_stage_by_span", "host_us_per_stage",
              "host_syncs_per_step"):
        assert k in rec, k
    assert len(rec["glue_breakdown_us"]) <= 5
    # three closure coefficient copies, the full closure, the read-back
    assert rec["host_syncs_per_step"] == pytest.approx(5 / 3)
    assert rec["host_us_per_stage"] > 0
    assert rec["trace_kernel_events"] == rec["trace_launches"]
    assert rec["hbm_bytes_per_stage_model"] > 0


def test_tools_run_on_the_cpu(monkeypatch):
    from remhos_torch.tools import kernelbench, microbench
    monkeypatch.setenv("BENCH_N", "2")
    out = microbench.main(device="cpu", n_inner=2)
    assert "gather kernel" in out and "gl_cg kernel" in out
    assert all(np.isfinite(v) and v > 0 for v in out.values())
    out = kernelbench.main(device="cpu", n_inner=2)
    assert len(out) == 3


def test_trace_drops_tool_on_the_cpu():
    """On the CPU the gather runs its plain version: nothing is launched and
    no capture can drop a kernel record."""
    from remhos_torch.tools import trace_drops
    out = trace_drops.main(device="cpu", rounds=1)
    assert out["device"] == "cpu"
    assert out["quiet_s"] == {str(q): {"captures": 4, "dropped": 0}
                              for q in trace_drops.QUIETS}


@pytest.mark.parametrize("measure_steps", [1, 5])
def test_bench_run_measure_steps(measure_steps):
    """The trace covers min(n_steps, measure_steps) steps of the loop."""
    case = bench.build_case(n=2, order=3, dtype=torch.float32, device="cpu",
                            n_steps=3)
    rec = bench.run(case, trace=True, measure_steps=measure_steps)
    assert rec["trace_steps"] == min(3, measure_steps)
    assert rec["steps"] == 3
