"""remhos_torch setup against remhos_tpu on the CPU: host tables, problem
setup, the lumped-mass polynomial, the stage tables and P, and the stage
glue (element extrema, bounds stencil, neighbour gather).

Both packages get the same numpy inputs; arrays from the JAX side cross into
the port's layout through remhos_torch.convert. Tolerances:
- float tables and setup values in f64: <= 1e-13 relative to the array's
  largest magnitude (both sides compute the same formulas; only the order
  of floating-point operations may differ);
- extrema, stencil and gather: bit-identical (min/max, shifts and an exact
  index gather, no arithmetic).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from remhos_tpu import bounds as jbnd
from remhos_tpu import driver as jdrv
from remhos_tpu import geometry as jgeo
from remhos_tpu import problems as jprob
from remhos_tpu import structured as jstr
from remhos_tpu.discretization import build_discretization as jbuild
from remhos_tpu.mesh import make_cartesian_mesh as jmesh
from remhos_tpu.ops import pallas_kernels as pk

from remhos_torch import bounds, convert, driver, geometry, problems
from remhos_torch import structured
from remhos_torch.discretization import build_discretization
from remhos_torch.mesh import make_cartesian_mesh
from remhos_torch.ops import tables

SHAPES = [(4, 3, 2), (4, 4, 4), (6, 4)]
REL = 1e-13


def _pair(shape, periodic=None, p=3):
    dim = len(shape)
    periodic = periodic or (False,) * dim
    args = (dim, shape, (0.0,) * dim, (1.0,) * dim, periodic)
    return jbuild(jmesh(*args), p), build_discretization(
        make_cartesian_mesh(*args), p)


def _close(a, b, rel=REL):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape
    scale = max(np.abs(b).max(), 1e-300)
    assert np.abs(a - b).max() <= rel * scale, np.abs(a - b).max() / scale


def _t(a):
    return convert.tensor(a)


@pytest.mark.parametrize("shape", SHAPES)
def test_host_tables(shape):
    jd, td = _pair(shape)
    a = convert.discretization_tables(td)
    b = convert.discretization_tables(jd)
    for k in b:
        _close(a[k], b[k])
    np.testing.assert_array_equal(td.mesh.x, jd.mesh.x)


@pytest.mark.parametrize("problem", range(10, 18))
@pytest.mark.parametrize("shape", [(4, 3, 2), (6, 4)])
def test_problem_setup(problem, shape):
    jd, td = _pair(shape)
    m = jd.mesh
    x0 = m.x
    u0j, xuj = jdrv._project_bernstein(
        jnp.asarray(x0), jd.Bm_at_unodes,
        lambda x: jprob.u0_function(problem, x, m.bb_min, m.bb_max))
    u0t, xut = driver._project_bernstein(
        _t(x0), td.Bm_at_unodes,
        lambda x: problems.u0_function(problem, x, m.bb_min, m.bb_max))
    _close(xut, xuj)
    _close(u0t, u0j)
    vj = jprob.velocity_function(problem, jnp.asarray(x0), m.bb_min,
                                 m.bb_max)
    vt = problems.velocity_function(problem, _t(x0), m.bb_min, m.bb_max)
    _close(vt, vj)
    assert problems.exec_mode_of(problem) == jprob.exec_mode_of(problem)


@pytest.mark.parametrize("shape", [(4, 3, 2), (6, 4)])
def test_integrate_mesh_velocity(shape):
    jd, td = _pair(shape)
    m = jd.mesh
    dt = 0.2 / 320
    vj = jdrv._integrate_mesh_velocity(m.x, jd.Bm, 10, m.bb_min, m.bb_max,
                                       0.7, dt)
    vt = driver._integrate_mesh_velocity(_t(m.x), 10, m.bb_min, m.bb_max,
                                         0.7, dt)
    _close(vt, vj)


@pytest.mark.parametrize("shape", SHAPES)
def test_geometry(shape):
    jd, td = _pair(shape)
    rng = np.random.default_rng(3)
    x0 = jd.mesh.x
    v = 0.1 * np.sin(x0) + 0.01 * rng.standard_normal(x0.shape)
    mj, sj = jgeo.lumped_mass_poly(jnp.asarray(x0), jnp.asarray(v), jd)
    mt, st = geometry.lumped_mass_poly(_t(x0), _t(v), td)
    _close(mt, mj)
    _close(st, sj)
    x = _t(x0 + 0.3 * v)
    _close(geometry.interp_nodes(x, _t(td.Bm)),
           jgeo.interp_nodes(jnp.asarray(x0 + 0.3 * v), jnp.asarray(jd.Bm)))
    Jt = geometry.jacobian_planes(x, _t(td.Gm))
    Jj = jgeo.jacobian_planes(jnp.asarray(x0 + 0.3 * v), jnp.asarray(jd.Gm))
    for d in range(len(shape)):
        for b in range(len(shape)):
            _close(Jt[d][b], Jj[d][b])
    detj, _ = jgeo.volume_detj_va(jnp.asarray(x0 + 0.3 * v),
                                  jnp.asarray(jd.Gm),
                                  jnp.zeros(x0.shape[:1] + (len(jd.w_q),
                                                            len(shape))), 1.0)
    _close(geometry.volume_detj(x, _t(td.Gm)), detj)
    gt, sgt = geometry.face_tangent_tables(td.Gmf, td.n_ref)
    gj, sgj = jgeo.face_tangent_tables(jd.Gmf, jd.n_ref)
    _close(gt, gj)
    np.testing.assert_array_equal(sgt, sgj)


@pytest.mark.parametrize("shape", SHAPES)
def test_stage_tables(shape):
    jd, td = _pair(shape)
    got = tables.stage_ho_tables(td, torch.float64, "cpu")
    ref = convert.stage_tables(pk.stage_ho_tables(jd, jnp.float64),
                               convert.discretization_tables(jd))
    for k, v in ref.items():
        if isinstance(v, int):
            assert got[k] == v, k
        elif v.dtype == torch.int32:
            assert torch.equal(got[k], v), k
        else:
            _close(got[k], v)


@pytest.mark.parametrize("shape", SHAPES)
def test_poly_tables(shape):
    jd, td = _pair(shape)
    rng = np.random.default_rng(4)
    x0 = jd.mesh.x
    v = 0.1 * np.sin(x0) + 0.01 * rng.standard_normal(x0.shape)
    Pj = pk.build_poly_tables(jnp.asarray(x0), jnp.asarray(v), jd)["P"]
    tb = pk.stage_ho_tables(jd, jnp.float64)
    Q, S = tb["Q"], tb["seg"]
    FQ = jd.n_ref.shape[0] * jd.Bface.shape[0]
    Pt = tables.build_poly_tables(_t(x0), _t(v), td)
    assert Pt.shape[1] == tables.poly_layout(len(shape), Q, FQ)["width"]
    _close(Pt, convert.poly(Pj, len(shape), Q, FQ, S))


@pytest.mark.parametrize("shape,periodic", [
    ((4, 3, 2), None), ((4, 3, 2), (True, False, True)),
    ((6, 4), None), ((6, 4), (True, True))])
def test_glue_bit_identical(shape, periodic):
    """elements_min_max, overlap_stencil_T and gather_nbr_structured give
    the same bits as the JAX functions, in f64 and f32."""
    jd, td = _pair(shape, periodic)
    m = jd.mesh
    rng = np.random.default_rng(5)
    u = rng.standard_normal((m.num_elements, jd.nd))
    for dtype, jdt in ((torch.float64, jnp.float64),
                       (torch.float32, jnp.float32)):
        uj, ut = jnp.asarray(u, jdt), convert.tensor(u, dtype)
        lo_j, hi_j = jbnd.elements_min_max(uj)
        lo_t, hi_t = bounds.elements_min_max(ut)
        np.testing.assert_array_equal(lo_t.numpy(), np.asarray(lo_j))
        np.testing.assert_array_equal(hi_t.numpy(), np.asarray(hi_j))
        sj = jstr.overlap_stencil_T(lo_j, hi_j, m.shape, m.periodic)
        st = structured.overlap_stencil_T(lo_t, hi_t, m.shape, m.periodic)
        for a, b in zip(st, sj):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        gj = jstr.gather_nbr_structured(uj, m.shape, m.periodic,
                                        jd.dofmaps.nbr_dof_local)
        gt = structured.gather_nbr_structured(ut, m.shape, m.periodic,
                                              td.dofmaps.nbr_dof_local)
        np.testing.assert_array_equal(gt.numpy(), np.asarray(gj))
