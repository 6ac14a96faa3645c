"""The assembled (FA) path's functions of remhos_torch against remhos_tpu on
the CPU: assembly.py, ho.py, the assembled lo.py, fct.element_fct_projection,
fct_flux.py and fct_penalty.py.

Each function gets the same numpy inputs from a seed on both sides, on the
tables of a small 2D (4x3, p=3) and a small 3D (2x2x2, p=2) mesh: random
geometry (detJ > 0, adj J, velocities, scaled normals), from which the
element matrices are assembled; those from the JAX side then feed the
solvers and limiters on both sides. Tolerances, relative to the largest
entry of the JAX result: 1e-12 in f64 (the same formulas in another
summation order); in f32 1e-5 for the assembly, which is sums of products
of O(1) terms, and 1e-3 for the solvers and limiters, whose f32 rounding
the mass inverse (condition ~1e3 at these orders) amplifies.
"""

import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from remhos_tpu import assembly as jasm
from remhos_tpu import fct as jfct
from remhos_tpu import fct_flux as jflux
from remhos_tpu import fct_penalty as jpen
from remhos_tpu import ho as jho
from remhos_tpu import lo as jlo
from remhos_tpu.discretization import build_discretization as jbuild
from remhos_tpu.mesh import make_cartesian_mesh as jmesh
from remhos_tpu.si import SmoothnessIndicator as JSI

from remhos_torch import assembly as asm
from remhos_torch import fct, fct_flux, fct_penalty, ho, lo
from remhos_torch.discretization import build_discretization
from remhos_torch.mesh import make_cartesian_mesh
from remhos_torch.si import SmoothnessIndicator
from torch_threads import one_torch_thread  # noqa: F401

DT = 0.01
PRECS = {"f64": (jnp.float64, torch.float64, 1e-12, 1e-12),
         "f32": (jnp.float32, torch.float32, 1e-5, 1e-3)}


class Case:
    """Seeded inputs on one mesh in one precision, with a converter to
    each side."""

    def __init__(self, shape, p, prec, seed=5):
        dim = len(shape)
        self.jdt, self.dtype, self.tol_asm, self.tol = PRECS[prec]
        jd = jbuild(jmesh(dim, shape, (0.0,) * dim, (1.0,) * dim,
                          (False,) * dim), p)
        self.jd, self.dim, self.p = jd, dim, p
        rng = np.random.default_rng(seed)
        E, Q, nd = jd.mesh.num_elements, len(jd.w_q), jd.nd
        nf, Qf = jd.n_ref.shape[0], len(jd.w_fq)
        self.E, self.nd = E, nd
        self.detJ = 0.5 + rng.random((E, Q))
        self.adjJ = (np.eye(dim) + 0.2 * rng.standard_normal(
            (E, Q, dim, dim)))
        self.v_q = rng.standard_normal((E, Q, dim))
        self.v_fq = rng.standard_normal((E, nf, Qf, dim))
        self.nor = rng.standard_normal((E, nf, Qf, dim))
        self.u = rng.random((E, nd))
        self.u_nbr = rng.random((E, nf, jd.fd))
        self.du_ho = rng.standard_normal((E, nd))
        self.du_lo = rng.standard_normal((E, nd))
        self.sub_w = rng.standard_normal(
            (E,) + jd.dofmaps.sub2ind.shape)
        self.rng = rng
        self.bdr = jd.dofmaps.bdr_dofs
        self.sub2ind = jd.dofmaps.sub2ind
        # the element matrices, assembled on the JAX side in this precision
        J = self.j
        self.K = np.asarray(jasm.element_convection(
            J(self.v_q), J(self.adjJ), J(jd.Bu), J(jd.Gu), J(jd.w_q), 1.0))
        self.M = np.asarray(jasm.element_mass(J(self.detJ), J(jd.Bu),
                                              J(jd.w_q)))
        self.bdrInt = np.asarray(jasm.face_upwind_matrices(
            J(self.v_fq), J(self.nor), J(jd.w_fq), J(jd.Bface), 1))
        self.ml = self.M.sum(2)

    def j(self, a):
        return jnp.asarray(a, self.jdt)

    def t(self, a):
        return torch.as_tensor(np.array(a), dtype=self.dtype)

    def idx(self, a):
        return torch.as_tensor(np.array(a), dtype=torch.long)

    def check(self, got, want, tol=None):
        tol = self.tol if tol is None else tol
        want = np.asarray(want, np.float64)
        got = got.double().numpy()
        assert got.shape == want.shape
        err, scale = np.abs(got - want).max(), np.abs(want).max()
        assert err <= tol * scale, (err, scale, err / scale)


CASES = [((4, 3), 3), ((2, 2, 2), 2)]


@pytest.fixture(scope="module", params=[(s, p, prec) for s, p in CASES
                                        for prec in PRECS],
                ids=lambda x: f"{len(x[0])}d-{x[2]}")
def case(request):
    return Case(*request.param)


def test_element_mass_and_lumped_mass(case):
    c, jd = case, case.jd
    M = asm.element_mass(c.t(c.detJ), c.t(jd.Bu), c.t(jd.w_q))
    c.check(M, c.M, c.tol_asm)
    c.check(asm.lumped_mass(M), jasm.lumped_mass(c.j(c.M)), c.tol_asm)


@pytest.mark.parametrize("sign", [1.0, -1.0])
def test_element_convection(case, sign):
    c, jd = case, case.jd
    K = asm.element_convection(c.t(c.v_q), c.t(c.adjJ), c.t(jd.Bu),
                               c.t(jd.Gu), c.t(jd.w_q), sign)
    c.check(K, jasm.element_convection(c.j(c.v_q), c.j(c.adjJ), c.j(jd.Bu),
                                       c.j(jd.Gu), c.j(jd.w_q), sign),
            c.tol_asm)


@pytest.mark.parametrize("exec_mode", [0, 1])
def test_face_upwind_matrices(case, exec_mode):
    c, jd = case, case.jd
    got = asm.face_upwind_matrices(c.t(c.v_fq), c.t(c.nor), c.t(jd.w_fq),
                                   c.t(jd.Bface), exec_mode)
    assert float(got.min()) >= 0.0
    c.check(got, jasm.face_upwind_matrices(c.j(c.v_fq), c.j(c.nor),
                                           c.j(jd.w_fq), c.j(jd.Bface),
                                           exec_mode), c.tol_asm)


def test_face_terms_and_apply_K_HO(case):
    c = case
    uf = c.u[:, c.bdr]
    for f_t, f_j in ((asm.face_term_full, jasm.face_term_full),
                     (asm.face_term_lumped, jasm.face_term_lumped)):
        c.check(f_t(c.t(uf), c.t(c.u_nbr), c.t(c.bdrInt)),
                f_j(c.j(uf), c.j(c.u_nbr), c.j(c.bdrInt)), c.tol_asm)
    c.check(asm.apply_K_HO(c.t(c.u), c.t(c.K), c.t(c.bdrInt),
                           c.t(c.u_nbr), c.idx(c.bdr)),
            jasm.apply_K_HO(c.j(c.u), c.j(c.K), c.j(c.bdrInt),
                            c.j(c.u_nbr), jnp.asarray(c.bdr)), c.tol_asm)


def test_cholesky_and_local_inverse(case):
    c = case
    L = ho.mass_cholesky(c.t(c.M))
    Lj = jho.mass_cholesky(c.j(c.M))
    c.check(L, Lj)
    rhs = c.rng.standard_normal((c.E, c.nd))
    c.check(ho.cho_solve(c.t(np.asarray(Lj)), c.t(rhs)),
            jho.cho_solve(Lj, c.j(rhs)))
    c.check(ho.local_inverse(c.t(rhs), c.t(np.asarray(Lj))),
            jho.local_inverse(c.j(rhs), Lj))


def test_cg_mass_solve(case):
    c = case
    rhs = c.rng.standard_normal((c.E, c.nd))
    stats = {}
    x = ho.cg_mass_solve(c.t(c.M), c.t(rhs), stats=stats)
    assert stats["solves"] == 1 and stats["iterations"] > 0
    c.check(x, jho.cg_mass_solve(c.j(c.M), c.j(rhs)))


def test_neumann(case):
    c = case
    rhs = 0.1 * c.rng.standard_normal((c.E, c.nd))
    c.check(ho.neumann(c.t(c.u), c.t(rhs), c.t(c.M), c.t(c.ml)),
            jho.neumann(c.j(c.u), c.j(rhs), c.j(c.M), c.j(c.ml)))


@pytest.mark.parametrize("subcell", [False, True])
def test_residual_distribution(case, subcell):
    c = case
    kw_t = dict(subcell=subcell, subcell_weights=c.t(c.sub_w),
                sub2ind=c.idx(c.sub2ind))
    kw_j = dict(subcell=subcell, subcell_weights=c.j(c.sub_w),
                sub2ind=jnp.asarray(c.sub2ind))
    c.check(lo.residual_distribution(c.t(c.u), c.t(c.u_nbr), c.t(c.K),
                                     c.t(c.bdrInt), c.t(c.ml), c.idx(c.bdr),
                                     **kw_t),
            jlo.residual_distribution(c.j(c.u), c.j(c.u_nbr), c.j(c.K),
                                      c.j(c.bdrInt), c.j(c.ml),
                                      jnp.asarray(c.bdr), **kw_j))
    c.check(lo._face_lumped_into_dofs(c.t(c.u), c.t(c.u_nbr),
                                      c.t(c.bdrInt), c.idx(c.bdr)),
            jlo._face_lumped_into_dofs(c.j(c.u), c.j(c.u_nbr),
                                       c.j(c.bdrInt), jnp.asarray(c.bdr)),
            c.tol_asm)


@pytest.mark.parametrize("precond", [False, True])
def test_discrete_upwind(case, precond):
    c = case
    K = c.K
    if precond:
        Kp = jlo.precond_convection_matrix(c.j(c.K), c.j(c.M))
        c.check(lo.precond_convection_matrix(c.t(c.K), c.t(c.M)), Kp)
        K = np.asarray(Kp)
    D = lo.discrete_upwind_matrix(c.t(K))
    Dj = jlo.discrete_upwind_matrix(c.j(K))
    c.check(D, Dj, c.tol_asm)
    c.check(lo.discrete_upwind(c.t(c.u), c.t(c.u_nbr), c.t(np.asarray(Dj)),
                               c.t(c.bdrInt), c.t(c.ml), c.idx(c.bdr)),
            jlo.discrete_upwind(c.j(c.u), c.j(c.u_nbr), Dj, c.j(c.bdrInt),
                                c.j(c.ml), jnp.asarray(c.bdr)))


def _bounds(c):
    """Per-dof bounds around u that the HO update violates here and there."""
    return (c.u - 0.5 * c.rng.random((c.E, c.nd)),
            c.u + 0.5 * c.rng.random((c.E, c.nd)))


def test_element_fct_projection(case):
    c = case
    umin, umax = _bounds(c)
    args = (c.u, c.du_ho, c.du_lo, umin, umax, c.M)
    c.check(fct.element_fct_projection(*map(c.t, args), DT),
            jfct.element_fct_projection(*map(c.j, args), DT))


def _adv(c, backend):
    """The operator attributes the flux-based and penalty limiters read."""
    bdr = c.idx(c.bdr) if backend == "torch" else jnp.asarray(c.bdr)
    w_q = c.t(c.jd.w_q) if backend == "torch" else c.j(c.jd.w_q)
    return types.SimpleNamespace(
        bdr_dofs=bdr, w_q=w_q, cfg=types.SimpleNamespace(smth_ind=0),
        disc=types.SimpleNamespace(dim=c.dim, p=c.p))


def _geom(c, conv):
    return dict(K_elem=conv(c.K), bdrInt=conv(c.bdrInt), M=conv(c.M),
                ml=conv(c.ml), detJ=conv(c.detJ))


def test_k_ho_diag_blocks(case):
    c = case
    c.check(fct_flux.k_ho_diag_blocks(c.t(c.K), c.t(c.bdrInt),
                                      c.idx(c.bdr)),
            jflux.k_ho_diag_blocks(c.j(c.K), c.j(c.bdrInt),
                                   jnp.asarray(c.bdr)), c.tol_asm)


def test_flux_based_fct(case):
    c = case
    umin, umax = _bounds(c)
    args = (c.u, c.du_ho, c.du_lo, umin, umax)
    got = fct_flux.flux_based_fct(_adv(c, "torch"), _geom(c, c.t),
                                  *map(c.t, args), DT)
    c.check(got, jflux.flux_based_fct(_adv(c, "jax"), _geom(c, c.j),
                                      *map(c.j, args), DT))


def test_fct_iterations_two_sweeps(case):
    c = case
    F = c.rng.standard_normal((c.E, c.nd, c.nd))
    F = 1e-3 * (F - F.transpose(0, 2, 1))
    umin, umax = _bounds(c)
    args = (F, c.u, c.du_lo, c.ml, umin, umax)
    c.check(fct_flux._fct_iterations(*map(c.t, args), DT, 2),
            jflux._fct_iterations(*map(c.j, args), DT, 2))


def test_flux_based_fct_product(case):
    c = case
    rng = c.rng
    us = c.u * (1.0 + rng.random((c.E, c.nd)))
    u_new = c.u.copy()
    u_new[0] = 0.0                                  # one empty element
    active_dofs = u_new > 1e-12
    active_el = active_dofs.any(1)
    s_min, s_max = 1.0 + 0.2 * rng.random((2, c.E, c.nd))
    us_min, us_max = s_min * u_new, (s_max + 1.0) * u_new
    d_us_lo = rng.standard_normal((c.E, c.nd))
    dus_lo_fct = rng.standard_normal((c.E, c.nd))
    args = (us, c.du_ho, d_us_lo, dus_lo_fct, s_min, s_max, us_min, us_max,
            u_new)
    got = fct_flux.flux_based_fct_product(
        _adv(c, "torch"), _geom(c, c.t), *map(c.t, args),
        torch.as_tensor(active_el), torch.as_tensor(active_dofs), DT)
    want = jflux.flux_based_fct_product(
        _adv(c, "jax"), _geom(c, c.j), *map(c.j, args),
        jnp.asarray(active_el), jnp.asarray(active_dofs), DT)
    c.check(got, want)


def test_nonlinear_penalty(case):
    c = case
    umin, umax = _bounds(c)
    args = (c.u, c.du_ho, c.du_lo, umin, umax)
    got = fct_penalty.nonlinear_penalty(_adv(c, "torch"), _geom(c, c.t),
                                        *map(c.t, args), DT)
    c.check(got, jpen.nonlinear_penalty(_adv(c, "jax"), _geom(c, c.j),
                                        *map(c.j, args), DT))


def test_nonlinear_penalty_with_si_names_its_item(case):
    """-fct 3 with -si, which named its ROADMAP item until the smoothness
    indicator was ported: the sharpened bounds (remhos_fct.cpp:779-794) of
    both indicator types against the JAX package's, whose indicator tables
    are f64."""
    c = case
    dim = c.dim
    disc = build_discretization(make_cartesian_mesh(
        dim, c.jd.mesh.shape, (0.0,) * dim, (1.0,) * dim, (False,) * dim),
        c.p)
    umin, umax = _bounds(c)
    args = (c.u, c.du_ho, c.du_lo, umin, umax)
    for si_type in (1, 2):
        adv_t, adv_j = _adv(c, "torch"), _adv(c, "jax")
        adv_t.cfg.smth_ind = adv_j.cfg.smth_ind = si_type
        adv_t.smth = SmoothnessIndicator(si_type, disc, c.dtype, "cpu")
        adv_j.smth = JSI(si_type, c.jd, c.jd.mesh.bb_min, c.jd.mesh.bb_max)
        got = fct_penalty.nonlinear_penalty(adv_t, _geom(c, c.t),
                                            *map(c.t, args), DT)
        c.check(got, jpen.nonlinear_penalty(adv_j, _geom(c, c.j),
                                            *map(c.j, args), DT))
