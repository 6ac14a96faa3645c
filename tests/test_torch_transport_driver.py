"""`driver.run` in transport mode (problems 0-7) against remhos_tpu's, on
the CPU, for a few steps.

f64: final mass 1e-12 relative, max u 1e-12, step counts equal, the L1
error and the steady-state residual 1e-10 relative. f32, with the Kahan
combine and the closure on the all-periodic mesh (transport on inline-quad
has a physical in- and outflow, and runs without the closure in both
packages): mass 1e-6 relative, max u 1e-5, the closure's injection within
5e-7 of the JAX package's, L1 1e-5 relative. Problem 5 (balls and jacks),
problems 6 and 7 (inflow, the steady-state residual) and the L1 errors of
problems 4 and 7. In f64 the reported initial range (u0_min, u0_max)
is the JAX package's projected initial condition's, to 1e-14.
"""

import pytest

import jax.numpy as jnp

from remhos_tpu import problems as jprob
from remhos_tpu.config import RunConfig as JConfig
from remhos_tpu.discretization import build_discretization as jdisc
from remhos_tpu.driver import _project_bernstein as jproject
from remhos_tpu.driver import run as jrun
from remhos_tpu.mesh import load_mesh as jload

from remhos_torch import driver
from remhos_torch.config import RunConfig
from torch_threads import one_torch_thread  # noqa: F401


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-300)


RUNS = {
    "ballsjacks": dict(mesh="periodic-square", problem=5, rs_levels=1,
                       dt=0.004, t_final=0.04, ho=2, lo=3, fct=2),
    "ring-steady": dict(mesh="inline-quad", problem=6, rs_levels=0, dt=0.01,
                        t_final=0.1, ho=2, lo=4, fct=2, max_tsteps=5),
    "tanh-ring-l1": dict(mesh="inline-quad", problem=7, rs_levels=0,
                         dt=0.01, t_final=0.1, ho=3, lo=3, fct=2,
                         max_tsteps=5),
    "zalesak-l1": dict(mesh="inline-quad", problem=4, rs_levels=0, dt=0.01,
                       t_final=0.05, ho=3, lo=5, fct=2),
}


@pytest.mark.parametrize("name", sorted(RUNS))
def test_driver_run_f64(name):
    cfg = dict(RUNS[name], pa=True, verbose=False)
    rj = jrun(JConfig(**cfg))
    rt = driver.run(RunConfig(device="cpu", **cfg))
    assert (rt.steps, rt.steps_total) == (rj.steps, rj.steps_total)
    assert _rel(rt.t, rj.t) <= 1e-13
    assert _rel(rt.final_mass_u, rj.final_mass_u) <= 1e-12
    assert abs(rt.max_u - rj.max_u) <= 1e-12
    # the steady-state residual of problems 6 and 7
    assert (rj.residual > 0) == (cfg["problem"] in (6, 7))
    assert _rel(rt.residual, rj.residual) <= 1e-10 or \
        rt.residual == rj.residual == 0.0
    assert (rt.l1_error >= 0) == (cfg["problem"] in (4, 7))
    if rt.l1_error >= 0:
        assert _rel(rt.l1_error, rj.l1_error) <= 1e-10
    assert rt.mass_closure_injected_rel == rj.mass_closure_injected_rel == 0
    # the initial condition's range, which the run reports beside min u
    jm = jload(cfg["mesh"], cfg["rs_levels"])
    dj = jdisc(jm, cfg.get("order", 3))
    u0, _ = jproject(jnp.asarray(jm.x), dj.Bm_at_unodes,
                     lambda x: jprob.u0_function(cfg["problem"], x,
                                                 jm.bb_min, jm.bb_max))
    assert abs(rt.u0_min - float(u0.min())) <= 1e-14
    assert abs(rt.u0_max - float(u0.max())) <= 1e-14


@pytest.mark.parametrize("name", ["ballsjacks", "tanh-ring-l1"])
def test_driver_run_f32(name):
    cfg = dict(RUNS[name], pa=True, verbose=False, dtype="float32")
    rj = jrun(JConfig(**cfg))
    rt = driver.run(RunConfig(device="cpu", **cfg))
    assert rt.steps == rj.steps
    assert _rel(rt.final_mass_u, rj.final_mass_u) <= 1e-6
    assert abs(rt.max_u - rj.max_u) <= 1e-5
    # the closure runs on the all-periodic mesh only
    closed = name == "ballsjacks"
    assert (rt.mass_closure_injected_rel > 0) == closed
    assert (rj.mass_closure_injected_rel > 0) == closed
    assert abs(rt.mass_closure_injected_rel
               - rj.mass_closure_injected_rel) <= 5e-7
    if rt.l1_error >= 0:
        assert _rel(rt.l1_error, rj.l1_error) <= 1e-5
