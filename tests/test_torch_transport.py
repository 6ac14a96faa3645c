"""Transport mode (problems 0-7) of remhos_torch against remhos_tpu, on the
CPU, in f64 unless marked.

- `problems.velocity_function` for pe 0-7 in dims 1-3 and
  `problems.inflow_function`, on seeded points: 1e-14 absolute; the
  problems without a velocity (8, 9, 18, 19) raise ValueError in both;
- the static transport geometry (detJ, wdet, va, wvn, ml, and the `-lo 4`
  subcell weights) against the JAX package's `Advection.geometry(0)` on
  periodic-square and periodic-cube, for constant velocities (problems 0,
  5) and problem 3's nonlinear swirl: 1e-12 of each array's largest entry;
  the port's `geometry(t)` is one dict for every t;
- one stage (`stage_function`: mult_unlimited, then limit_mult) for
  `-ho 2|3 -lo 3|4|5 -fct 0|2 -pa` on inline-quad with problem 7's inflow
  and on periodic-cube, and for problem 3 with `-lo 4` on both: 1e-12 of
  max|dS|;
- problem 7's two-step inflow projection: 1e-14 of its largest value.

`driver.run` in transport mode is held in tests/test_torch_transport_driver.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from remhos_tpu import problems as jprob
from remhos_tpu.discretization import build_discretization as jdisc
from remhos_tpu.mesh import load_mesh as jload
from remhos_tpu.operator import Advection as JAdvection
from remhos_tpu.operator import SolverConfig as JSolver

from remhos_torch import driver, problems
from remhos_torch.discretization import build_discretization
from remhos_torch.mesh import load_mesh
from remhos_torch.operator import Advection, SolverConfig
from torch_threads import one_torch_thread  # noqa: F401

F64 = torch.float64


def _points(dim, seed):
    return np.random.default_rng(seed).uniform(-1.0, 1.0, (6, 5, dim))


@pytest.mark.parametrize("dim", [1, 2, 3])
def test_velocity_and_inflow_functions(dim):
    x = _points(dim, 10 + dim)
    bb = (-np.ones(dim), np.ones(dim))
    for problem in range(8):
        want = np.asarray(jprob.velocity_function(problem, jnp.asarray(x),
                                                  *bb))
        got = problems.velocity_function(problem, torch.tensor(x),
                                         *bb).numpy()
        assert got.shape == want.shape == x.shape
        assert np.abs(got - want).max() <= 1e-14, problem
        want = np.asarray(jprob.inflow_function(problem, jnp.asarray(x)))
        got = problems.inflow_function(problem, torch.tensor(x)).numpy()
        assert got.shape == want.shape
        assert np.abs(got - want).max() <= 1e-14, problem


@pytest.mark.parametrize("problem", [8, 9, 18, 19])
def test_problems_without_velocity_raise_value_error(problem):
    x = _points(2, 3)
    bb = (-np.ones(2), np.ones(2))
    with pytest.raises(ValueError):
        jprob.velocity_function(problem, jnp.asarray(x), *bb)
    with pytest.raises(ValueError):
        problems.velocity_function(problem, torch.tensor(x), *bb)


def _operators(mesh, rs, order, problem, inflow=False, **solver):
    """(JAX Advection, port Advection, port disc) on one registry mesh, f64.
    With `inflow`, both get the same seeded inflow values."""
    jm, tm = jload(mesh, rs, 2), load_mesh(mesh, rs, 2)
    dj, dt_ = jdisc(jm, order), build_discretization(tm, order)
    infl = None
    if inflow:
        infl = np.random.default_rng(7).uniform(
            0.0, 1.0, (tm.num_elements, dt_.nd))
    cfg = dict(problem=problem, pa=True, **solver)
    aj = JAdvection(dj, JSolver(**cfg), jnp.asarray(jm.x), None,
                    None if infl is None else jnp.asarray(infl))
    at = Advection(dt_, SolverConfig(**cfg), torch.tensor(tm.x), None,
                   dtype=F64, device="cpu",
                   inflow=None if infl is None else torch.tensor(infl))
    return aj, at, dt_


def _close(got, want, tol):
    want = np.asarray(want)
    got = got.numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


@pytest.mark.parametrize("mesh,rs,order,problem", [
    ("periodic-square", 1, 3, 5), ("periodic-cube", 0, 2, 0),
    ("periodic-square", 1, 3, 3), ("periodic-cube", 0, 2, 3)])
def test_static_transport_geometry(mesh, rs, order, problem):
    aj, at, _ = _operators(mesh, rs, order, problem, ho=2, lo=4, fct=2)
    gj, gt = aj.geometry(0.0), at.geometry(0.0)
    for key in ("detJ", "wdet", "va", "wvn", "ml", "sub_w"):
        _close(gt[key], gj[key], 1e-12)
    assert at.geometry(0.37) is gt
    assert at.lumped_mass(0.5) is gt["ml"]


STAGES = [(ho, lo, fct) for ho in (2, 3) for lo in (3, 4, 5)
          for fct in (0, 2)]


@pytest.mark.parametrize("ho,lo,fct", STAGES)
def test_one_stage_with_inflow(ho, lo, fct):
    """inline-quad is not periodic: problem 7's inflow values enter the LO
    solutions' neighbour gather on its boundary."""
    aj, at, disc = _operators("inline-quad", 1, 2, 7, inflow=True, ho=ho,
                              lo=lo, fct=fct)
    rng = np.random.default_rng(100 * ho + 10 * lo + fct)
    S = rng.uniform(0.0, 1.0, (1, at.x0_nodes.shape[0], disc.nd))
    t, dt = 0.3, 0.01
    dj, auxj = aj.stage_function()(t, dt, jnp.asarray(S))
    dt_, auxt = at.stage_function()(t, dt, torch.tensor(S))
    _close(dt_, dj, 1e-12)
    assert np.array_equal(np.asarray(auxj), auxt.numpy())


@pytest.mark.parametrize("ho,lo", [(3, 5), (2, 4)])
def test_one_stage_periodic_cube(ho, lo):
    aj, at, disc = _operators("periodic-cube", 0, 2, 0, ho=ho, lo=lo, fct=2)
    S = np.random.default_rng(5).uniform(
        0.0, 1.0, (1, at.x0_nodes.shape[0], disc.nd))
    dj, _ = aj.stage_function()(0.0, 0.015, jnp.asarray(S))
    dt_, _ = at.stage_function()(0.0, 0.015, torch.tensor(S))
    _close(dt_, dj, 1e-12)


@pytest.mark.parametrize("mesh,rs,inflow", [("inline-quad", 1, True),
                                            ("periodic-cube", 0, False)])
@pytest.mark.parametrize("ho", [2, 3])
def test_one_stage_swirl(mesh, rs, inflow, ho):
    """Problem 3's velocity is not linear in x: the subcell weights' value
    at the corners' mean is not the mean of the corner values, and the
    quadrature and face points' velocities differ from any interpolant of
    the nodal ones."""
    aj, at, disc = _operators(mesh, rs, 2, 3, inflow=inflow, ho=ho, lo=4,
                              fct=2)
    S = np.random.default_rng(30 + ho).uniform(
        0.0, 1.0, (1, at.x0_nodes.shape[0], disc.nd))
    dj, auxj = aj.stage_function()(0.1, 0.01, jnp.asarray(S))
    dt_, auxt = at.stage_function()(0.1, 0.01, torch.tensor(S))
    _close(dt_, dj, 1e-12)
    assert np.array_equal(np.asarray(auxj), auxt.numpy())


def test_inflow_projection_of_problem_7():
    """The two-step projection (GL interpolant at the control points)."""
    tm = load_mesh("inline-quad", 0, 2)
    disc = build_discretization(tm, 3)
    x0 = torch.tensor(tm.x)
    got = driver.inflow_projection(7, x0, disc)
    jm = jload("inline-quad", 0, 2)
    dj = jdisc(jm, 3)
    x_gl = jnp.einsum("end,mn->emd", jnp.asarray(jm.x),
                      jnp.asarray(dj.Bm_at_glnodes))
    want = jnp.einsum("mk,ek->em", jnp.asarray(dj.T_gl_to_unif),
                      jprob.inflow_function(7, x_gl))
    _close(got, want, 1e-14)
    assert driver.inflow_projection(5, x0, disc) is None
