"""The modules under the non-fused PA stage of remhos_torch against their
remhos_tpu twins on the CPU: `pa`, `assembly`, `lo.residual_distribution_core`,
`subcell`, `geometry.face_normals_tangent` and `det_adj`.

Same numpy inputs on both sides. Tolerances, relative to the largest entry
of the JAX result: 1e-12 in f64 (the same formulas, sums in another order).
The CG solves are compared at equal iteration counts in f64 (the JAX count
is read off by capping `max_iter`), their residual |M du - rhs| against the
JAX package's own 1e-7 (tests/test_foundations.py:171); in f32 the result
within 1e-4 of max|du| (the stopping test sits at a relative residual of
1e-6, so one iteration more or less moves the result by about that much).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from remhos_tpu import assembly as jasm
from remhos_tpu import geometry as jgeo
from remhos_tpu import lo as jlo
from remhos_tpu import pa as jpa
from remhos_tpu import subcell as jsub
from remhos_tpu.discretization import build_discretization as jbuild
from remhos_tpu.mesh import make_cartesian_mesh as jmesh
from remhos_tpu.operator import Advection as JAdvection
from remhos_tpu.operator import SolverConfig as JConfig

from remhos_torch import assembly, convert, geometry, lo, pa, subcell
from remhos_torch.discretization import build_discretization
from remhos_torch.mesh import make_cartesian_mesh
from remhos_torch.operator import Advection, SolverConfig

t64 = convert.tensor
J = jnp.asarray
# (shape, periodic, p)
MESHES = [((4, 4, 4), (False,) * 3, 3), ((6, 6), (False, True), 3),
          ((3, 2, 2), (False,) * 3, 2)]


def _rel(a, b):
    b = np.asarray(b, np.float64)
    a = np.asarray(a, np.float64)
    assert a.shape == b.shape
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _setup(shape, periodic, p, seed):
    dim = len(shape)
    args = (dim, shape, (0.0,) * dim, (1.0,) * dim, periodic)
    jd = jbuild(jmesh(*args), p)
    td = build_discretization(make_cartesian_mesh(*args), p)
    return jd, td, np.random.default_rng(seed)


def _idx(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.long)


def _moved(jd, t=0.4):
    x0 = jd.mesh.x
    # compression and shear: det J varies inside every element (a pure
    # shear leaves M_gl diagonal, and CG done after one iteration)
    return x0 + t * 0.2 * np.sin(3.0 * x0) * np.cos(2.0 * x0[..., ::-1])


@pytest.mark.parametrize("shape,periodic,p", MESHES)
def test_actions_match_jax(shape, periodic, p):
    """mass_action, face_flux_q, face_full_apply, face_lumped_apply,
    gather_face and scatter_face_add (whose indices repeat on edges)."""
    jd, td, rng = _setup(shape, periodic, p, 1)
    E, nd, Q = jd.mesh.num_elements, jd.nd, jd.w_q.shape[0]
    nf, fd = jd.dofmaps.bdr_dofs.shape
    Qf = jd.w_fq.shape[0]
    u, wdet = rng.standard_normal((E, nd)), rng.random((E, Q)) + 0.1
    u_nbr = rng.standard_normal((E, nf, fd))
    wvn = rng.random((E, nf, Qf))
    contrib = rng.standard_normal((E, nf, fd))
    bdr = jd.dofmaps.bdr_dofs
    np.testing.assert_array_equal(td.dofmaps.bdr_dofs, bdr)
    assert len(np.unique(bdr)) < bdr.size           # repeated indices
    assert _rel(pa.mass_action(t64(u), t64(wdet), t64(td.Bu)),
                jpa.mass_action(J(u), J(wdet), J(jd.Bu))) <= 1e-12
    uf_t = assembly.gather_face(t64(u), _idx(bdr))
    uf_j = jasm.gather_face(J(u), J(bdr))
    np.testing.assert_array_equal(uf_t.numpy(), np.asarray(uf_j))
    for name in ("face_flux_q", "face_full_apply", "face_lumped_apply"):
        got = getattr(pa, name)(uf_t, t64(u_nbr), t64(td.Bface), t64(wvn))
        ref = getattr(jpa, name)(uf_j, J(u_nbr), J(jd.Bface), J(wvn))
        assert _rel(got, ref) <= 1e-12, name
    y = t64(u)
    got = assembly.scatter_face_add(y, t64(contrib), _idx(bdr))
    assert _rel(got, jasm.scatter_face_add(J(u), J(contrib), J(bdr))) <= 1e-12
    np.testing.assert_array_equal(y.numpy(), u)     # y itself is untouched


@pytest.mark.parametrize("shape,periodic,p", MESHES)
def test_face_normals_and_det_adj(shape, periodic, p):
    jd, td, rng = _setup(shape, periodic, p, 2)
    xs = _moved(jd)
    Gt_j, s_j = jgeo.face_tangent_tables(jd.Gmf, jd.n_ref)
    Gt_t, s_t = geometry.face_tangent_tables(td.Gmf, td.n_ref)
    nor_j = jgeo.face_normals_tangent(J(xs), J(Gt_j), J(s_j))
    nor_t = geometry.face_normals_tangent(t64(xs), t64(Gt_t), t64(s_t))
    assert _rel(nor_t, nor_j) <= 1e-12
    # the Nanson normals of the adjugate path agree too
    _, nor_a = jgeo.face_geometry(J(xs), J(jd.Bmf), J(jd.Gmf), J(jd.n_ref))
    assert _rel(nor_t, nor_a) <= 1e-12
    dim = len(shape)
    Jm = rng.standard_normal((5, 7, dim, dim))
    det_j, adj_j = jgeo.det_adj(J(Jm))
    det_t, adj_t = geometry.det_adj(t64(Jm))
    assert _rel(det_t, det_j) <= 1e-14 and _rel(adj_t, adj_j) <= 1e-14
    eye = np.einsum("...ab,...bc->...ac", adj_t.numpy(), Jm)
    assert np.abs(eye - det_t.numpy()[..., None, None] * np.eye(dim)).max() \
        <= 1e-13 * np.abs(eye).max()


def _jax_iterations(solve, ref, k):
    """True when the JAX solve took exactly k iterations: capped at k it
    gives its uncapped result, capped at k - 1 it does not."""
    same_k = np.array_equal(np.asarray(solve(k)), ref)
    same_km1 = k > 0 and np.array_equal(np.asarray(solve(k - 1)), ref)
    return same_k and not same_km1


@pytest.mark.parametrize("shape,periodic,p", MESHES)
def test_mass_solves_match_jax_with_equal_counts(shape, periodic, p):
    jd, td, rng = _setup(shape, periodic, p, 3)
    E, nd = jd.mesh.num_elements, jd.nd
    xs = _moved(jd)
    wdet = jd.w_q[None, :] * np.asarray(
        jgeo.volume_geometry(J(xs), J(jd.Bm), J(jd.Gm))["detJ"])
    assert wdet.min() > 0
    rhs = rng.standard_normal((E, nd)) * wdet.mean()

    # Gauss-Legendre basis CG (-ho 3)
    ref = np.asarray(jpa.mass_solve_gl(J(rhs), J(wdet), J(jd.Bgl),
                                       J(jd.A_gl2b)))
    stats = {}
    got = pa.mass_solve_gl(t64(rhs), t64(wdet), t64(td.Bgl), t64(td.A_gl2b),
                           stats=stats)
    assert stats["solves"] == 1 and 2 <= stats["iterations"] <= 12
    assert _jax_iterations(
        lambda k: jpa.mass_solve_gl(J(rhs), J(wdet), J(jd.Bgl), J(jd.A_gl2b),
                                    max_iter=k), ref, stats["iterations"])
    assert _rel(got, ref) <= 1e-12
    res = pa.mass_action(got, t64(wdet), t64(td.Bu)).numpy() - rhs
    assert np.abs(res).max() <= 1e-7 * np.abs(rhs).max()

    # Bernstein mass action CG (-ho 2): kappa(D^-1 M_bern) is large at
    # p = 3 in 3D, where the solve takes ~360 iterations and the two
    # packages' roundings part ways: the counts then agree to a few percent
    # (362 against 369 here) and the solutions to 1e-10. Below a hundred
    # iterations the counts are equal.
    ref = np.asarray(jpa.mass_solve_bern(J(rhs), J(wdet), J(jd.Bu)))
    stats = {}
    got = pa.mass_solve_bern(t64(rhs), t64(wdet), t64(td.Bu), stats=stats)
    k = stats["iterations"]
    assert stats["solves"] == 1 and 10 <= k < 500

    def jax_bern(max_iter):
        return jpa.mass_solve_bern(J(rhs), J(wdet), J(jd.Bu),
                                   max_iter=max_iter)

    if k < 150:
        assert _jax_iterations(jax_bern, ref, k)
    else:
        assert not np.array_equal(np.asarray(jax_bern(int(0.95 * k))), ref)
        assert np.array_equal(np.asarray(jax_bern(int(1.05 * k))), ref)
    assert _rel(got, ref) <= 1e-10
    res = pa.mass_action(got, t64(wdet), t64(td.Bu)).numpy() - rhs
    assert np.abs(res).max() <= 1e-7 * np.abs(rhs).max()


def test_mass_solves_f32():
    """float32: the tolerance clamp (1e-6) and true f32 products; the JAX
    side runs its dots at Precision.HIGHEST. The count may differ by one
    where rr sits at the threshold, so only the result is compared."""
    jd, td, rng = _setup(*MESHES[0], 4)
    E, nd = jd.mesh.num_elements, jd.nd
    wdet = jd.w_q[None, :] * np.asarray(jgeo.volume_geometry(
        J(_moved(jd)), J(jd.Bm), J(jd.Gm))["detJ"])
    rhs = rng.standard_normal((E, nd)) * wdet.mean()
    f32, j32 = torch.float32, jnp.float32
    for tname, targs, jargs, most in (
            ("mass_solve_gl", (td.Bgl, td.A_gl2b), (jd.Bgl, jd.A_gl2b), 10),
            ("mass_solve_bern", (td.Bu,), (jd.Bu,), 499)):
        ref = getattr(jpa, tname)(J(rhs, j32), J(wdet, j32),
                                  *[J(a, j32) for a in jargs])
        stats = {}
        got = getattr(pa, tname)(t64(rhs, f32), t64(wdet, f32),
                                 *[t64(a, f32) for a in targs], stats=stats)
        assert got.dtype == f32 and 1 <= stats["iterations"] <= most
        assert _rel(got, ref) <= 1e-4, tname
        # and against the f64 solution: the f32 solve is a solve
        ref64 = getattr(jpa, tname)(J(rhs), J(wdet), *[J(a) for a in jargs])
        assert _rel(got, ref64) <= 1e-3, tname


def _rd_inputs(jd, rng):
    E, nd = jd.mesh.num_elements, jd.nd
    u = rng.random((E, nd))
    u[0] = 0.37                  # all dofs equal: the +-EPS denominators
    u[1] = 0.0
    u[2, ::2] = 1.0              # several dofs at the maximum
    z = rng.standard_normal((E, nd))
    z[3] = 0.0                   # no residual to distribute
    z[4] = np.abs(z[4])          # rhoN = 0
    duf = rng.standard_normal((E, nd))
    ml = rng.random((E, nd)) + 0.1
    return u, z, duf, ml


@pytest.mark.parametrize("shape,periodic,p", MESHES)
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12),
                                       (torch.float32, 2e-5)])
def test_residual_distribution_core(shape, periodic, p, dtype, tol):
    jd, td, rng = _setup(shape, periodic, p, 5)
    u, z, duf, ml = _rd_inputs(jd, rng)
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    sub2ind = jd.dofmaps.sub2ind
    np.testing.assert_array_equal(td.dofmaps.sub2ind, sub2ind)
    assert len(np.unique(sub2ind)) < sub2ind.size    # repeated indices
    sub_w = rng.standard_normal((u.shape[0],) + sub2ind.shape)
    a_t = [t64(a, dtype) for a in (u, z, duf, ml)]
    a_j = [J(a, jdt) for a in (u, z, duf, ml)]
    got = lo.residual_distribution_core(*a_t)
    ref = jlo.residual_distribution_core(*a_j)
    assert got.dtype == dtype and np.isfinite(got.numpy()).all()
    assert _rel(got, ref) <= tol
    got = lo.residual_distribution_core(
        *a_t, subcell=True, subcell_weights=t64(sub_w, dtype),
        sub2ind=_idx(sub2ind))
    ref = jlo.residual_distribution_core(
        *a_j, subcell=True, subcell_weights=J(sub_w, jdt),
        sub2ind=J(sub2ind))
    assert np.isfinite(got.numpy()).all()
    assert _rel(got, ref) <= tol
    assert lo.EPS == jlo.EPS == 1e-15


def test_residual_distribution_conserves_the_residual():
    """The weights of each sign sum to one, so the element sum of ml * du
    is that of the face accumulator plus the residual's."""
    jd, td, rng = _setup(*MESHES[1], 6)
    u, z, duf, ml = _rd_inputs(jd, rng)
    keep = np.ones(len(u), bool)
    keep[:2] = False             # constant elements distribute ~nothing
    du = lo.residual_distribution_core(*[t64(a) for a in (u, z, duf, ml)])
    lhs = (ml * du.numpy()).sum(1)
    rhs = (duf + z).sum(1)
    assert np.abs(lhs - rhs)[keep].max() <= 1e-12 * np.abs(rhs).max()


def _operators(shape, periodic, p, lo_kind=4, problem=10):
    jd, td, rng = _setup(shape, periodic, p, 7)
    x0 = jd.mesh.x
    v = 0.1 * np.sin(x0)
    kw = dict(problem=problem, ho=3, lo=lo_kind, fct=2, pa=True)
    jadv = JAdvection(jd, JConfig(use_pallas=True, **kw), J(x0), J(v), None)
    adv = Advection(td, SolverConfig(**kw), x0, v, dtype=torch.float64,
                    device="cpu")
    return jadv, adv


@pytest.mark.parametrize("shape,periodic,p", MESHES)
def test_subcell_setup_and_weights(shape, periodic, p):
    jadv, adv = _operators(shape, periodic, p)
    jd, td = jadv.disc, adv.disc
    dim = len(shape)
    np.testing.assert_array_equal(subcell.q1_center_grads(dim),
                                  jsub.q1_center_grads(dim))
    np.testing.assert_array_equal(td.ref_nodes_u, jd.ref_nodes_u)
    mask_t = subcell.boundary_node_mask(td.mesh, td.ref_nodes_u)
    np.testing.assert_array_equal(
        mask_t, jsub.boundary_node_mask(jd.mesh, jd.ref_nodes_u))
    assert mask_t.any() and not mask_t.all()
    for a, b in zip(adv._subcell_nodes, jadv._subcell_nodes):
        assert _rel(a, b) <= 1e-13
    # the subcell velocity vanishes on physical boundaries, not on periodic
    v_sub = adv._subcell_nodes[1].numpy()
    assert np.abs(v_sub[mask_t]).max() == 0.0
    if any(periodic):
        assert np.abs(v_sub[~mask_t]).max() > 0.0
    for t in (0.0, 0.65):
        wj = jsub.subcell_weights(jadv, t)
        wt = subcell.subcell_weights(adv, t)
        assert tuple(wt.shape) == (jd.mesh.num_elements, p ** dim, 2 ** dim)
        assert _rel(wt, wj) <= 1e-12


def test_subcell_weights_float32_stay_float32():
    jd, td, rng = _setup(*MESHES[1], 8)
    x0 = jd.mesh.x
    adv = Advection(td, SolverConfig(problem=10, ho=2, lo=4, fct=2, pa=True),
                    x0, 0.1 * np.sin(x0), dtype=torch.float32, device="cpu")
    assert all(a.dtype == torch.float32 for a in adv._subcell_nodes)
    assert subcell.subcell_weights(adv, 0.3).dtype == torch.float32
    assert adv.geometry(0.3)["sub_w"].dtype == torch.float32
