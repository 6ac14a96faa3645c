"""1D meshes in remhos_torch against remhos_tpu on the CPU.

- the registry segment and its refinements, the discretization tables, the
  dof tables (faces, neighbour dofs, CG node ids, subcells) at p = 1-3 and
  mesh orders 1-3: equal (the same numpy arithmetic);
- the geometry: det J and adj J, the volume rule's geometry, the face
  points and normals from the face Jacobians (`face_tangent_tables` is
  None in 1D), `volume_detj_va`, the lumped mass polynomial: 1e-14;
- the structured neighbour gather, periodic and not, with and without
  boundary values: equal; the transport subcell weights: 1e-13;
- a 1D remap operator with -pa (which the driver never builds: the
  reference disables PA in 1D) runs the plain volume_detj_va route and no
  kernel: one limited stage against the JAX operator's, 1e-12;
- tests/test_driver.py::test_1d_transport through both drivers (1e-12),
  with its gates; `-pa` in 1D runs the assembled path, bit for bit.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from remhos_tpu import driver as jdriver
from remhos_tpu import geometry as jgeo
from remhos_tpu import structured as jstr
from remhos_tpu import subcell as jsub
from remhos_tpu.config import RunConfig as JConfig
from remhos_tpu.discretization import build_discretization as jbuild
from remhos_tpu.mesh import load_mesh as jload
from remhos_tpu.mesh import make_cartesian_mesh as jmesh
from remhos_tpu.operator import Advection as JAdvection
from remhos_tpu.operator import SolverConfig as JSolverConfig

from remhos_torch import driver, geometry, ops, structured
from remhos_torch.config import RunConfig
from remhos_torch.discretization import build_discretization
from remhos_torch.dofmaps import cg_node_ids, neighbour_elements
from remhos_torch.mesh import load_mesh, make_cartesian_mesh
from remhos_torch.operator import Advection, SolverConfig
from torch_threads import one_torch_thread  # noqa: F401

TABLES = ("w_q", "Bu", "Gu", "Bm", "Gm", "w_fq", "Bface", "Bmf", "Gmf",
          "n_ref", "ref_nodes_u", "Bm_at_unodes", "Bm_at_glnodes",
          "T_gl_to_unif", "Bgl", "A_gl2b")


def _close(got, want, tol):
    got = got.double().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max() if got.size else 0.0
    assert err <= tol * max(np.abs(want).max() if want.size else 0.0,
                            1e-300), err


@pytest.mark.parametrize("rs", [0, 2])
@pytest.mark.parametrize("mo", [1, 2, 3])
def test_mesh_and_tables_match_jax(rs, mo):
    jm, tm = jload("periodic-segment", rs, mo), load_mesh("periodic-segment",
                                                         rs, mo)
    assert (tm.dim, tm.shape, tm.periodic) == (jm.dim, jm.shape, jm.periodic)
    np.testing.assert_array_equal(tm.x, jm.x)
    np.testing.assert_array_equal(neighbour_elements(tm.shape, tm.periodic),
                                  jm.nbr_elem)
    np.testing.assert_array_equal(tm.element_sizes(), jm.element_sizes())
    for p in (1, 2, 3):
        jd, td = jbuild(jm, p), build_discretization(tm, p)
        for name in TABLES:
            np.testing.assert_array_equal(getattr(td, name),
                                          getattr(jd, name), err_msg=name)
        jdm, tdm = jd.dofmaps, td.dofmaps
        for name in ("bdr_dofs", "nbr_dof_local", "sub2ind"):
            np.testing.assert_array_equal(getattr(tdm, name),
                                          getattr(jdm, name), err_msg=name)
        assert (tdm.nd, tdm.fd, tdm.nfaces) == (jdm.nd, jdm.fd, jdm.nfaces)
        cg, n_cg = cg_node_ids(tm.shape, tm.periodic, p)
        np.testing.assert_array_equal(cg, jdm.cg_idx)
        assert n_cg == jdm.n_cg


def test_non_periodic_segment():
    args = (1, (5,), (0.0,), (2.0,), (False,))
    jm, tm = jmesh(*args), make_cartesian_mesh(*args)
    np.testing.assert_array_equal(tm.x, jm.x)
    np.testing.assert_array_equal(neighbour_elements(tm.shape, tm.periodic),
                                  jm.nbr_elem)


def _moved_nodes(mesh, seed=0):
    rng = np.random.default_rng(seed)
    return mesh.x * (1.0 + 0.05 * rng.random(mesh.x.shape))


def test_geometry_matches_jax():
    jm, tm = jload("periodic-segment", 1, 3), load_mesh("periodic-segment",
                                                        1, 3)
    jd, td = jbuild(jm, 3), build_discretization(tm, 3)
    x = _moved_nodes(jm)
    xt, xj = torch.as_tensor(x), jnp.asarray(x)
    assert geometry.face_tangent_tables(td.Gmf, td.n_ref) is None
    tv = geometry.volume_geometry(xt, *map(torch.as_tensor, (td.Bm, td.Gm)))
    jv = jgeo.volume_geometry(xj, jnp.asarray(jd.Bm), jnp.asarray(jd.Gm))
    for k in ("x_q", "detJ", "adjJ"):
        _close(tv[k], jv[k], 1e-14)
    tf = geometry.face_geometry(xt, *map(torch.as_tensor,
                                         (td.Bmf, td.Gmf, td.n_ref)))
    jf = jgeo.face_geometry(xj, *map(jnp.asarray, (jd.Bmf, jd.Gmf,
                                                   jd.n_ref)))
    for g, w in zip(tf, jf):
        _close(g, w, 1e-14)
    v = np.random.default_rng(1).standard_normal(x.shape)
    mk, sig = geometry.lumped_mass_poly(xt, torch.as_tensor(v), td)
    jmk, jsig = jgeo.lumped_mass_poly(xj, jnp.asarray(v), jd)
    _close(mk, jmk, 1e-14)
    _close(sig, jsig, 1e-14)


def test_volume_detj_va_matches_jax():
    dim, shape = 1, (3,)
    args = (dim, shape, (0.0,) * dim, (1.0,) * dim, (False,) * dim)
    jd, td = jbuild(jmesh(*args), 2), build_discretization(
        make_cartesian_mesh(*args), 2)
    x = _moved_nodes(jd.mesh, dim)
    v_q = np.random.default_rng(dim).standard_normal(
        (x.shape[0], len(jd.w_q), dim))
    for sign in (1.0, -1.0):
        got = geometry.volume_detj_va(torch.as_tensor(x),
                                      torch.as_tensor(td.Gm),
                                      torch.as_tensor(v_q), sign)
        want = jgeo.volume_detj_va(jnp.asarray(x), jnp.asarray(jd.Gm),
                                   jnp.asarray(v_q), sign)
        for g, w in zip(got, want):
            _close(g, w, 1e-14)


@pytest.mark.parametrize("periodic", [True, False])
def test_gather_nbr_1d_matches_jax(periodic):
    args = (1, (6,), (0.0,), (1.0,), (periodic,))
    jd, td = jbuild(jmesh(*args), 3), build_discretization(
        make_cartesian_mesh(*args), 3)
    rng = np.random.default_rng(5)
    u = rng.standard_normal((6, 4))
    bdr = rng.standard_normal((6, 2, 1))
    for bv in (None, bdr):
        got = structured.gather_nbr_structured(
            torch.as_tensor(u), (6,), (periodic,), td.dofmaps.nbr_dof_local,
            bdr_value=None if bv is None else torch.as_tensor(bv))
        want = jstr.gather_nbr_structured(
            jnp.asarray(u), (6,), (periodic,), jd.dofmaps.nbr_dof_local,
            bdr_value=None if bv is None else jnp.asarray(bv))
        _close(got, want, 0.0)


def test_transport_subcell_weights_1d_match_jax():
    jd = jbuild(jload("periodic-segment", 1), 3)
    td = build_discretization(load_mesh("periodic-segment", 1), 3)
    kw = dict(problem=0, ho=3, lo=4, fct=2, pa=False)
    jadv = JAdvection(jd, JSolverConfig(**kw), jnp.asarray(jd.mesh.x))
    tadv = Advection(td, SolverConfig(**kw), td.mesh.x,
                     dtype=torch.float64, device="cpu")
    _close(tadv.geometry(0.0)["sub_w"], jsub.subcell_weights(jadv, 0.0),
           1e-13)


@pytest.mark.parametrize("ho,lo", [(3, 3), (2, 5)])
def test_remap_pa_1d_operator_matches_jax(ho, lo):
    """A 1D remap -pa operator (built directly, with a seeded mesh
    velocity) runs volume_detj_va and conv_action in plain PyTorch: one
    limited stage equals the JAX operator's and no kernel launches."""
    jd = jbuild(jload("periodic-segment", 2), 3)
    td = build_discretization(load_mesh("periodic-segment", 2), 3)
    rng = np.random.default_rng(9)
    x0 = jd.mesh.x
    v = 0.05 * np.sin(2 * np.pi * x0) + 0.01 * rng.random(x0.shape)
    u = rng.random((x0.shape[0], jd.nd))
    kw = dict(problem=10, ho=ho, lo=lo, fct=2, pa=True)
    jadv = JAdvection(jd, JSolverConfig(**kw), jnp.asarray(x0),
                      jnp.asarray(v))
    tadv = Advection(td, SolverConfig(**kw), x0, v, dtype=torch.float64,
                     device="cpu")
    assert not tadv._fused_stage and tadv._wdet_tables is None
    ops.reset_launch_counts()
    t, dt = 0.3, 0.01
    dS, aux = tadv.stage_function()(t, dt, torch.as_tensor(u)[None])
    jdS, jaux = jadv.stage_function()(t, dt, jnp.asarray(u)[None])
    _close(dS, jdS, 1e-12)
    assert all(n == 0 for n in ops.launch_counts().values())


ONE_D = dict(mesh="periodic-segment", problem=0, rs_levels=3, order=3,
             dt=0.001, t_final=0.02, ho=3, lo=3, fct=2, verbose=False)


def test_1d_transport_driver_matches_jax():
    rj = jdriver.run(JConfig(**ONE_D))
    rt = driver.run(RunConfig(device="cpu", **ONE_D))
    assert rt.steps == rj.steps == 20
    for a, b in ((rt.final_mass_u, rj.final_mass_u), (rt.max_u, rj.max_u)):
        assert abs(a - b) <= 1e-12 * abs(b)
    assert rt.mass_loss_u < 1e-13 and rt.max_u <= 1.0 + 1e-10


def test_1d_pa_runs_assembled():
    """The reference disables PA in 1D (remhos.cpp:474-480): `-pa` and
    no `-pa` are the same run."""
    kw = dict(ONE_D, ho=2, lo=4, max_tsteps=5, device="cpu")
    r_pa = driver.run(RunConfig(pa=True, **kw))
    r_fa = driver.run(RunConfig(pa=False, **kw))
    assert (r_pa.final_mass_u, r_pa.max_u) == (r_fa.final_mass_u, r_fa.max_u)
    assert r_pa.cg_solves == r_fa.cg_solves > 0
