"""The operator of remhos_torch (the non-mega fused stage) and the modules
under it against remhos_tpu on the CPU.

Same numpy inputs on both sides, fields with empty and partly empty
elements (u at or below EMPTY_ZONE_TOL), which is where the masked `where`
fills, the +-inf extrema and the false NaN comparisons matter. The JAX
operator is `Advection(use_pallas=True)`, whose Pallas kernels run in
interpret mode on the CPU. Tolerances:
- overlap bounds, masks, activity indicators, violation counts: exactly
  equal (minima, maxima and comparisons of the same numbers);
- sync, verify and fct product values: <= 1e-13 * scale (same formulas);
- mult_unlimited, limit_mult, stage_function: dS <= 1e-9 * max|dS| in f64
  (the JAX package's own Pallas-vs-XLA bar), the aux dt ratio <= 1e-9
  relative, the aux violation count equal;
- lumped_mass(t) through the wdet path: <= 1e-13 * max|ml|.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from remhos_tpu import bounds as jbnd
from remhos_tpu import fct as jfct
from remhos_tpu import pa as jpa
from remhos_tpu import structured as jstr
from remhos_tpu import sync as jsync
from remhos_tpu import verify as jvfy
from remhos_tpu.discretization import build_discretization as jbuild
from remhos_tpu.mesh import make_cartesian_mesh as jmesh
from remhos_tpu.operator import Advection as JAdvection
from remhos_tpu.operator import SolverConfig as JConfig

from remhos_torch import bounds, convert, fct, pa, structured, sync, verify
from remhos_torch.discretization import build_discretization
from remhos_torch.mesh import make_cartesian_mesh
from remhos_torch.operator import Advection, SolverConfig
from remhos_torch.ops import mega_stage as ms
from remhos_torch.ops import stage_ho as sh
from remhos_torch.ops import wdet as wd

T_STAGE, DT = 0.3, 0.01
# (shape, periodic, p)
MESHES = [((4, 3, 2), (False,) * 3, 3), ((6, 4), (False,) * 2, 3),
          ((4, 4), (True, True), 2)]
t64 = convert.tensor


def _close(a, b, tol=1e-13):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    assert a.shape == b.shape
    fin = np.isfinite(b)
    np.testing.assert_array_equal(a[~fin], b[~fin])     # the same +-inf
    scale = max(np.abs(b[fin]).max(), 1e-300) if fin.any() else 1.0
    assert np.abs(a[fin] - b[fin]).max(initial=0.0) <= tol * scale


def _same(a, b):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _field(rng, E, nd):
    """u >= 0 with empty elements (all dofs 0), partly empty ones (some
    dofs 0 or below EMPTY_ZONE_TOL) and full ones."""
    u = rng.random((E, nd))
    kind = rng.integers(0, 3, size=E)
    kind[:3] = (0, 1, 2)
    u[kind == 0] = 0.0
    part = rng.random((E, nd)) < 0.4
    u[(kind == 1)[:, None] & part] = 0.0
    u[1, -1] = 1e-13                      # below the tolerance: inactive
    return u


def _setup(shape, periodic, p, seed):
    dim = len(shape)
    args = (dim, shape, (0.0,) * dim, (1.0,) * dim, periodic)
    jd = jbuild(jmesh(*args), p)
    td = build_discretization(make_cartesian_mesh(*args), p)
    rng = np.random.default_rng(seed)
    E, nd = jd.mesh.num_elements, jd.nd
    return jd, td, rng, E, nd


@pytest.mark.parametrize("shape,periodic,p", MESHES)
@pytest.mark.parametrize("masked", [False, True])
def test_overlap_bounds_structured_bit_identical(shape, periodic, p, masked):
    jd, td, rng, E, nd = _setup(shape, periodic, p, 1)
    for dtype, jdt in ((torch.float64, jnp.float64),
                       (torch.float32, jnp.float32)):
        lo = rng.standard_normal(E)
        hi = lo + rng.random(E)
        act = rng.random(E) < 0.6 if masked else None
        jmin, jmax = jstr.overlap_bounds_structured(
            jnp.asarray(lo, jdt), jnp.asarray(hi, jdt), shape, periodic, p,
            active_el=None if act is None else jnp.asarray(act))
        tmin, tmax = structured.overlap_bounds_structured(
            t64(lo, dtype), t64(hi, dtype), shape, periodic, p,
            active_el=None if act is None else torch.tensor(act))
        assert tmin.dtype == dtype and tuple(tmin.shape) == (E, nd)
        _same(tmin, jmin)
        _same(tmax, jmax)


def test_elements_min_max_with_masks():
    rng = np.random.default_rng(2)
    u = rng.standard_normal((7, 9))
    dofs = rng.random((7, 9)) < 0.5
    dofs[0] = False                       # an element with no active dof
    el = dofs.any(axis=1)
    el[1] = False
    for kw_j, kw_t in (
            ({}, {}),
            (dict(active_dof=jnp.asarray(dofs)),
             dict(active_dof=torch.tensor(dofs))),
            (dict(active_el=jnp.asarray(el), active_dof=jnp.asarray(dofs)),
             dict(active_el=torch.tensor(el),
                  active_dof=torch.tensor(dofs)))):
        jl, jh = jbnd.elements_min_max(jnp.asarray(u), **kw_j)
        tl, th = bounds.elements_min_max(t64(u), **kw_t)
        _same(tl, jl)
        _same(th, jh)


def test_sync_functions():
    rng = np.random.default_rng(3)
    u = _field(rng, 12, 16)
    us = u * (2.0 + rng.random((12, 16)))
    jel, jdofs = jsync.bool_indicators(jnp.asarray(u))
    tel, tdofs = sync.bool_indicators(t64(u))
    _same(tel, jel)
    _same(tdofs, jdofs)
    assert not tel.all() and tel.any() and not bool(tdofs[1, -1])
    js, jel2, jd2 = jsync.compute_ratio(jnp.asarray(us), jnp.asarray(u))
    ts, tel2, td2 = sync.compute_ratio(t64(us), t64(u))
    _same(tel2, jel2)
    _same(td2, jd2)
    _close(ts, js)
    x = rng.standard_normal((12, 16))
    _same(sync.zero_out_empty_dofs(tel, tdofs, t64(x)),
          jsync.zero_out_empty_dofs(jel, jdofs, jnp.asarray(x)))
    jmin, jmax = jsync.min_max_s(jnp.asarray(us), jnp.asarray(u))
    tmin, tmax = sync.min_max_s(t64(us), t64(u))
    _close(tmin, jmin)
    _close(tmax, jmax)
    assert sync.EMPTY_ZONE_TOL == jsync.EMPTY_ZONE_TOL


def test_verify_functions_count_equally():
    rng = np.random.default_rng(4)
    E, nd = 10, 8
    u = rng.random((E, nd))
    du = rng.standard_normal((E, nd))
    lo = u - 0.02 * rng.random((E, nd))
    hi = u + 0.02 * rng.random((E, nd))
    act = rng.random((E, nd)) < 0.7
    el = act.any(axis=1)
    el[0] = False
    J, T = jnp.asarray, t64
    tb = torch.tensor
    assert verify.TOL == jvfy.TOL == 1e-12
    for a in (None, act):
        cj = jvfy.count_out_of_bounds(J(u + 0.05 * du), J(lo), J(hi),
                                      active=None if a is None else J(a))
        ct = verify.count_out_of_bounds(T(u + 0.05 * du), T(lo), T(hi),
                                        active=None if a is None else tb(a))
        assert ct.dtype == torch.int32 and int(ct) == int(cj) > 0
    assert int(verify.check_violation(T(u), 0.05, T(du), T(lo), T(hi))) == \
        int(jvfy.check_violation(J(u), 0.05, J(du), J(lo), J(hi)))
    # exactly at the bounds, and inside the tolerance: no violation
    assert int(verify.count_out_of_bounds(T(lo) - 5e-13, T(lo), T(hi))) == 0
    m_us, m_u = rng.random(E), rng.random(E) + 0.1
    s_avg = m_us / m_u + 0.3 * rng.standard_normal(E)
    smin, smax = s_avg - rng.random(E) * 0.4, s_avg + rng.random(E) * 0.4
    smin[2], smax[2] = np.inf, -np.inf           # no active dof there
    cj = jvfy.check_s_avg(J(m_us), J(m_u), J(s_avg), J(smin), J(smax), J(el))
    ct = verify.check_s_avg(T(m_us), T(m_u), T(s_avg), T(smin), T(smax),
                            tb(el))
    assert int(ct) == int(cj) > 0
    cj = jvfy.check_final_us(J(u), 0.05, J(du), J(lo), J(hi), J(el), J(act))
    ct = verify.check_final_us(T(u), 0.05, T(du), T(lo), T(hi), tb(el),
                               tb(act))
    assert int(ct) == int(cj) > 0
    u_lo = rng.random((E, nd))
    us_lo = u_lo * (2.0 + 0.5 * rng.standard_normal((E, nd)))
    s_lo, s_hi = 1.8 + 0 * u, 2.2 + 0 * u
    cj = jvfy.verify_lo_product(J(us_lo), J(u_lo), J(s_lo), J(s_hi), J(el),
                                J(act))
    ct = verify.verify_lo_product(T(us_lo), T(u_lo), T(s_lo), T(s_hi),
                                  tb(el), tb(act))
    assert int(ct) == int(cj) > 0


@pytest.mark.parametrize("seed", [5, 6])
def test_fct_product_functions(seed):
    rng = np.random.default_rng(seed)
    E, nd = 14, 16
    u_new = _field(rng, E, nd)
    s = 2.0 + rng.random((E, nd))
    us = u_new * s + 0.01 * rng.standard_normal((E, nd)) * (u_new > 0)
    m = rng.random((E, nd)) + 0.1
    d_us = rng.standard_normal((E, nd))
    s_min, s_max = s - 0.3 * rng.random((E, nd)), s + 0.3 * rng.random((E, nd))
    jel, jdofs = jsync.bool_indicators(jnp.asarray(u_new))
    tel, tdofs = sync.bool_indicators(t64(u_new))
    J, T = jnp.asarray, t64
    rj = jfct.calc_compatible_lo_product(J(us), J(m), J(d_us), J(s_min),
                                         J(s_max), J(u_new), jel, jdofs, DT)
    rt = fct.calc_compatible_lo_product(T(us), T(m), T(d_us), T(s_min),
                                        T(s_max), T(u_new), tel, tdofs, DT)
    for a, b in zip(rt[:3], rj[:3]):
        _close(a, b)
    assert rt[3].dtype == torch.int32 and int(rt[3]) == int(rj[3])
    bj = jfct.scale_product_bounds(rj[1], rj[2], J(u_new), jel, jdofs)
    bt = fct.scale_product_bounds(rt[1], rt[2], T(u_new), tel, tdofs)
    for a, b in zip(bt, bj):
        _close(a, b)
    assert fct.EPS_PROD == jfct.EPS_PROD


def test_lumped_mass_pa():
    rng = np.random.default_rng(7)
    wdet, Bu = rng.random((5, 27)), rng.random((27, 8))
    _close(pa.lumped_mass_pa(t64(wdet), t64(Bu)),
           jpa.lumped_mass_pa(jnp.asarray(wdet), jnp.asarray(Bu)))


# ---------------------------------------------------------------------------
# the operator
# ---------------------------------------------------------------------------

def _operators(shape, periodic, p, seed, nfields, **cfg_kw):
    jd, td, rng, E, nd = _setup(shape, periodic, p, seed)
    x0 = jd.mesh.x
    v = 0.1 * np.sin(x0)
    kw = dict(problem=10, ho=3, lo=5, fct=2, pa=True, **cfg_kw)
    jadv = JAdvection(jd, JConfig(use_pallas=True, **kw), jnp.asarray(x0),
                      jnp.asarray(v), None)
    assert jadv._fused_stage
    adv = Advection(td, SolverConfig(**kw), x0, v, dtype=torch.float64,
                    device="cpu")
    u = _field(rng, E, nd)
    fields = [u]
    if nfields == 2:
        fields.append(u * (2.0 + rng.random((E, nd))))
    S = np.stack(fields)
    return jadv, adv, S


def _check_stage(res_t, res_j):
    (dSt, auxt), (dSj, auxj) = res_t, res_j
    dSj = np.asarray(dSj)
    assert tuple(dSt.shape) == dSj.shape
    assert np.abs(dSt.numpy() - dSj).max() <= 1e-9 * np.abs(dSj).max()
    auxj = np.asarray(auxj)
    assert tuple(auxt.shape) == (2,) and auxt.dtype == dSt.dtype
    rt, rj = float(auxt[0]), float(auxj[0])
    assert rt == rj if np.isinf(rj) else abs(rt - rj) <= 1e-9 * abs(rj)
    assert float(auxt[1]) == float(auxj[1])       # -violations
    return rj, -float(auxj[1])


CASES = {
    "vb": (1, dict(verify_bounds=True)),
    "dtc": (1, dict(dt_control=1)),
    "two_fields": (2, dict(product_sync=True)),
    "two_fields_vb_dtc": (2, dict(product_sync=True, verify_bounds=True,
                                  dt_control=1)),
}


@pytest.mark.parametrize("shape,periodic,p", MESHES)
@pytest.mark.parametrize("case", list(CASES))
def test_stage_function_matches_jax(shape, periodic, p, case):
    nfields, cfg_kw = CASES[case]
    jadv, adv, S = _operators(shape, periodic, p, 11, nfields, **cfg_kw)
    assert not (nfields == 1 and adv._mega_stage_eligible())
    before = (ms.mega_stage.launches, sh.stage_ho.launches, wd.wdet.launches)
    res_t = adv.stage_function()(T_STAGE, DT, t64(S))
    assert before == (ms.mega_stage.launches, sh.stage_ho.launches,
                      wd.wdet.launches)         # CPU: plain versions only
    ratio, viol = _check_stage(
        res_t, jadv.stage_function()(T_STAGE, DT, jnp.asarray(S)))
    if cfg_kw.get("dt_control"):
        assert np.isfinite(ratio)
    else:
        assert np.isinf(ratio)
    if not cfg_kw.get("verify_bounds"):
        assert viol == 0


@pytest.mark.parametrize("shape,periodic,p", MESHES[:2])
@pytest.mark.parametrize("nfields", [1, 2])
def test_mult_unlimited_then_limit_mult(shape, periodic, p, nfields):
    """The two halves called as the IDP steppers call them: a shared stage
    cache, and the HO update changed between the calls (so the LO solution
    is computed from it, not taken from the kernel)."""
    jadv, adv, S = _operators(shape, periodic, p, 12, nfields,
                              product_sync=nfields == 2, verify_bounds=True,
                              dt_control=1, ode_solver=13)
    gj, gt = jadv.geometry(T_STAGE), adv.geometry(T_STAGE)
    dSj = jadv.mult_unlimited(T_STAGE, DT, jnp.asarray(S), geom=gj)
    dSt = adv.mult_unlimited(T_STAGE, DT, t64(S), geom=gt)
    assert "du_LO_fused" not in gt and "wdet" in gt
    assert np.abs(dSt.numpy() - np.asarray(dSj)).max() <= \
        1e-9 * np.abs(np.asarray(dSj)).max()
    res_j = jadv.limit_mult(T_STAGE, DT, jnp.asarray(S), 0.5 * dSj, geom=gj)
    res_t = adv.limit_mult(T_STAGE, DT, t64(S), 0.5 * dSt, geom=gt)
    _check_stage(res_t, res_j)


@pytest.mark.parametrize("shape,periodic,p", MESHES[:2])
def test_standalone_limit_mult_and_lumped_mass(shape, periodic, p):
    """limit_mult without a stage cache derives wdet from the nodes (the
    wdet path), and so does lumped_mass(t)."""
    jadv, adv, S = _operators(shape, periodic, p, 13, 2, product_sync=True,
                              verify_bounds=True)
    rng = np.random.default_rng(14)
    dS = rng.standard_normal(S.shape)
    res_j = jadv.limit_mult(T_STAGE, DT, jnp.asarray(S), jnp.asarray(dS))
    res_t = adv.limit_mult(T_STAGE, DT, t64(S), t64(dS))
    _check_stage(res_t, res_j)
    for t in (0.0, 0.7):
        mlj = np.asarray(jadv.lumped_mass(jnp.asarray(t)))
        mlt = adv.lumped_mass(t)
        assert np.abs(mlt.numpy() - mlj).max() <= 1e-13 * np.abs(mlj).max()


def test_fused_lo_is_asked_for_once():
    """With two fields the stage function asks the first HO launch for the
    LO solution and no later one; the cached LO equals the plain one."""
    jadv, adv, S = _operators((4, 3, 2), (False,) * 3, 3, 15, 2,
                              product_sync=True)
    calls = []
    import remhos_torch.operator as op
    real = op.stage_ho

    def spy(*a, **kw):
        calls.append(kw["with_lo"])
        return real(*a, **kw)

    op.stage_ho = spy
    try:
        adv.stage_function()(T_STAGE, DT, t64(S))
    finally:
        op.stage_ho = real
    assert calls == [True, False]


def test_compute_mask_matches_jax():
    jadv, adv, S = _operators((6, 4), (False,) * 2, 3, 16, 2,
                              product_sync=True)
    _same(adv.compute_mask(t64(S)), jadv.compute_mask(jnp.asarray(S)))
    assert not adv.compute_mask(t64(S)).all()
    _same(adv.compute_mask(t64(S[:1])),
          jadv.compute_mask(jnp.asarray(S[:1])))


def test_lo_only_and_unlimited_configs():
    """-lo 5 without FCT (the LO solution is the update) and -ho 3 alone."""
    for kw in (dict(lo=5, fct=0, dt_control=1), dict(lo=0, fct=0)):
        jd, td, rng, E, nd = _setup((6, 4), (False,) * 2, 3, 17)
        x0 = jd.mesh.x
        v = 0.1 * np.sin(x0)
        base = dict(problem=10, ho=3, pa=True)
        jadv = JAdvection(jd, JConfig(use_pallas=True, **base, **kw),
                          jnp.asarray(x0), jnp.asarray(v), None)
        adv = Advection(td, SolverConfig(**base, **kw), x0, v,
                        dtype=torch.float64, device="cpu")
        S = _field(rng, E, nd)[None]
        _check_stage(adv.stage_function()(T_STAGE, DT, t64(S)),
                     jadv.stage_function()(T_STAGE, DT, jnp.asarray(S)))
