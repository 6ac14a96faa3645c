"""The non-fused PA stage of remhos_torch.operator.Advection against
remhos_tpu's `Advection(use_pallas=True)` on the CPU.

Same numpy inputs on both sides (fields with empty and partly empty
elements). On the JAX side `fused_wdet` and `fused_geom_conv` run in
interpret mode; the port runs on CPU tensors, where `wdet` and `geom_conv`
run their plain versions. Tolerances in f64:
- `geometry(t)`: 1e-12 of each entry's scale;
- `mult_unlimited`, `limit_mult`, `stage_function` (the five (ho, lo)
  pairs on every mesh are in tests/test_torch_pa_stage.py): dS <= 1e-10 * max|dS|
  with `-ho 3` (a CG of 4-5 iterations to a relative 1e-12). With `-ho 2` the
  Bernstein CG runs for a hundred iterations and more at p = 3, over which
  the two packages' roundings part ways (tests/test_torch_pa.py): the bar is
  1e-9 there, the JAX package's own Pallas-vs-XLA bar;
- the aux dt ratio <= 1e-9 relative, the -vb violation count equal.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from remhos_tpu.discretization import build_discretization as jbuild
from remhos_tpu.mesh import make_cartesian_mesh as jmesh
from remhos_tpu.operator import Advection as JAdvection
from remhos_tpu.operator import SolverConfig as JConfig

from remhos_torch import convert, steppers
from remhos_torch.discretization import build_discretization
from remhos_torch.mesh import make_cartesian_mesh
from remhos_torch.operator import Advection, SolverConfig
from remhos_torch.ops import geom_conv as gc
from remhos_torch.ops import mega_stage as ms
from remhos_torch.ops import stage_ho as sh
from remhos_torch.ops import wdet as wd

from remhos_tpu import steppers as jst

T_STAGE, DT = 0.3, 0.01
# (shape, periodic, p)
MESHES = [((4, 3, 2), (False,) * 3, 3), ((6, 6), (False,) * 2, 3),
          ((4, 4), (True, True), 2)]
PAIRS = [(3, 3), (2, 3), (2, 4), (3, 4), (2, 5)]        # (ho, lo)
t64 = convert.tensor


def _field(rng, E, nd):
    """u >= 0 with empty elements, partly empty ones and full ones."""
    u = rng.random((E, nd))
    kind = rng.integers(0, 3, size=E)
    kind[:3] = (0, 1, 2)
    u[kind == 0] = 0.0
    part = rng.random((E, nd)) < 0.4
    u[(kind == 1)[:, None] & part] = 0.0
    return u


def _operators(shape, periodic, p, seed, nfields, **cfg_kw):
    dim = len(shape)
    args = (dim, shape, (0.0,) * dim, (1.0,) * dim, periodic)
    jd = jbuild(jmesh(*args), p)
    td = build_discretization(make_cartesian_mesh(*args), p)
    rng = np.random.default_rng(seed)
    x0 = jd.mesh.x
    v = 0.1 * np.sin(3.0 * x0) * np.cos(2.0 * x0[..., ::-1])
    kw = dict(dict(problem=10, fct=2, pa=True), **cfg_kw)
    jadv = JAdvection(jd, JConfig(use_pallas=True, **kw), jnp.asarray(x0),
                      jnp.asarray(v), None)
    adv = Advection(td, SolverConfig(**kw), x0, v, dtype=torch.float64,
                    device="cpu")
    assert not jadv._fused_stage and not adv._fused_stage
    u = _field(rng, jd.mesh.num_elements, jd.nd)
    fields = [u]
    if nfields == 2:
        fields.append(u * (2.0 + rng.random(u.shape)))
    return jadv, adv, np.stack(fields)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _tol(ho):
    return 1e-10 if ho == 3 else 1e-9


def _check_stage(res_t, res_j, tol):
    (dSt, auxt), (dSj, auxj) = res_t, res_j
    assert _rel(dSt, dSj) <= tol
    auxj = np.asarray(auxj)
    assert tuple(auxt.shape) == (2,) and auxt.dtype == dSt.dtype
    rt, rj = float(auxt[0]), float(auxj[0])
    assert rt == rj if np.isinf(rj) else abs(rt - rj) <= 1e-9 * abs(rj)
    assert float(auxt[1]) == float(auxj[1])       # -violations
    return -float(auxj[1])


def _kernel_counts():
    return (ms.mega_stage.launches, sh.stage_ho.launches, wd.wdet.launches,
            gc.geom_conv.launches)


@pytest.mark.parametrize("shape,periodic,p", MESHES)
@pytest.mark.parametrize("lo", [3, 4])
def test_geometry_matches_jax(shape, periodic, p, lo):
    jadv, adv, _ = _operators(shape, periodic, p, 1, 1, ho=3, lo=lo)
    for t in (0.0, T_STAGE):
        gj, gt = jadv.geometry(t), adv.geometry(t)
        keys = ["detJ", "wdet", "wvn", "ml", "xs"] + (
            ["sub_w"] if lo == 4 else [])
        for k in keys:
            assert _rel(gt[k], gj[k]) <= 1e-12, k
        assert float(gt["wvn"].min()) >= 0.0 and float(gt["wvn"].max()) > 0
        assert ("sub_w" in gt) == (lo == 4) and "va" not in gj
        mlj = jadv.lumped_mass(jnp.asarray(t))
        assert _rel(adv.lumped_mass(t), mlj) <= 1e-13


@pytest.mark.parametrize("ho,lo", PAIRS[:4])
def test_mult_unlimited_then_limit_mult(ho, lo):
    """The two halves as the IDP steppers call them: a shared stage cache,
    du_HO changed between the calls, -vb and dt control on."""
    jadv, adv, S = _operators(*MESHES[1], 3, 2, ho=ho, lo=lo,
                              product_sync=True, verify_bounds=True,
                              dt_control=1, ode_solver=13)
    gj, gt = jadv.geometry(T_STAGE), adv.geometry(T_STAGE)
    dSj = jadv.mult_unlimited(T_STAGE, DT, jnp.asarray(S), geom=gj)
    dSt = adv.mult_unlimited(T_STAGE, DT, t64(S), geom=gt)
    assert _rel(dSt, dSj) <= _tol(ho)
    res_j = jadv.limit_mult(T_STAGE, DT, jnp.asarray(S), 0.5 * dSj, geom=gj)
    res_t = adv.limit_mult(T_STAGE, DT, t64(S), 0.5 * dSt, geom=gt)
    _check_stage(res_t, res_j, _tol(ho))
    assert np.isfinite(float(res_t[1][0]))      # a dt ratio was estimated
    # without a cache both halves make their own geometry
    res_t = adv.limit_mult(T_STAGE, DT, t64(S), 0.5 * dSt)
    _check_stage(res_t, res_j, _tol(ho))


def test_vb_counts_equal():
    """-vb on a rough field: the LO and FCT checks of u and the product
    checks count the same dofs on both sides."""
    for lo in (3, 4):
        jadv, adv, S = _operators(*MESHES[1], 4, 2, ho=3, lo=lo,
                                  product_sync=True, verify_bounds=True)
        big = 40 * DT           # far past the CFL limit: LO leaves its bounds
        viol = _check_stage(
            adv.stage_function()(T_STAGE, big, t64(S)),
            jadv.stage_function()(T_STAGE, big, jnp.asarray(S)), 1e-10)
        assert viol > 0
        viol = _check_stage(
            adv.stage_function()(T_STAGE, 1e-3 * DT, t64(S)),
            jadv.stage_function()(T_STAGE, 1e-3 * DT, jnp.asarray(S)), 1e-10)
        assert viol == 0


@pytest.mark.parametrize("kind", [12, 13])
def test_idp_step_matches_jax(kind):
    """One IDP-RK step of two fields through the shared stage caches."""
    jadv, adv, S = _operators(*MESHES[1], 5, 2, ho=3, lo=3,
                              product_sync=True, ode_solver=kind)
    step_j = jst.make_idp_step(jadv.mult_unlimited, jadv.limit_mult, kind,
                               compute_mask=jadv.compute_mask,
                               geometry=jadv.geometry)
    step_t = steppers.make_idp_step(adv.mult_unlimited, adv.limit_mult, kind,
                                    compute_mask=adv.compute_mask,
                                    geometry=adv.geometry)
    Sj, _ = step_j(jnp.asarray(S), 0.2, DT)
    St, _ = step_t(t64(S), 0.2, DT)
    assert _rel(St, Sj) <= 1e-11
    # per stage: one HO solve per field
    stages = {12: 2, 13: 3}[kind]
    assert adv.cg_stats["solves"] == 2 * stages


def test_lo_only_and_unlimited_configs():
    """-fct 0: the RD solution alone is the update; -ho 2 alone."""
    for kw in (dict(ho=3, lo=3, fct=0, dt_control=1),
               dict(ho=2, lo=4, fct=0), dict(ho=2, lo=0, fct=0)):
        cfg_kw = dict(kw)
        jadv, adv, S = _operators(*MESHES[1], 6, 1, **cfg_kw)
        _check_stage(adv.stage_function()(T_STAGE, DT, t64(S)),
                     jadv.stage_function()(T_STAGE, DT, jnp.asarray(S)),
                     _tol(kw["ho"]))
        assert adv.cg_stats["solves"] == (0 if kw["lo"] else 1)


def test_float32_stage_stays_float32():
    """The f32 operator: every table and result in f32 (no silent
    promotion), close to the f64 stage."""
    _, adv64, S = _operators(*MESHES[1], 7, 2, ho=3, lo=4, product_sync=True)
    adv32 = Advection(adv64.disc, adv64.cfg, adv64.x0_nodes.numpy(),
                      adv64.v_nodes.numpy(), dtype=torch.float32,
                      device="cpu")
    dS32, aux32 = adv32.stage_function()(T_STAGE, DT, t64(S, torch.float32))
    dS64, _ = adv64.stage_function()(T_STAGE, DT, t64(S))
    assert dS32.dtype == aux32.dtype == torch.float32
    assert _rel(dS32, dS64) <= 1e-3


@pytest.mark.parametrize("kw,fused,mega", [
    (dict(ho=3, lo=5, fct=2), True, True),
    (dict(ho=3, lo=5, fct=2, verify_bounds=True), True, False),
    (dict(ho=3, lo=0, fct=0), True, False),
    (dict(ho=3, lo=5, fct=0), True, False),
    (dict(ho=3, lo=3, fct=2), False, False),
    (dict(ho=2, lo=5, fct=2), False, False),
    (dict(ho=2, lo=0, fct=0), False, False)])
def test_gate_is_the_reference_gate(kw, fused, mega):
    """Which configurations construct the fused operator, and which of
    those the mega stage: the same on both sides; the fused operator holds
    no non-fused table and the other way round."""
    dim, shape = 2, (3, 3)
    args = (dim, shape, (0.0,) * dim, (1.0,) * dim, (False,) * dim)
    jd = jbuild(jmesh(*args), 2)
    td = build_discretization(make_cartesian_mesh(*args), 2)
    x0 = jd.mesh.x
    v = 0.1 * np.sin(x0)
    base = dict(problem=10, pa=True)
    jadv = JAdvection(jd, JConfig(use_pallas=True, **base, **kw),
                      jnp.asarray(x0), jnp.asarray(v), None)
    adv = Advection(td, SolverConfig(**base, **kw), x0, v,
                    dtype=torch.float64, device="cpu")
    assert adv._fused_stage == jadv._fused_stage == fused
    assert adv._mega_stage_eligible() == jadv._mega_stage_eligible() == mega
    assert hasattr(adv, "_poly") == fused
    assert hasattr(adv, "_gc_tables") == (not fused)


def test_fused_family_launches_what_it_launched():
    """On the fused family the stage function still goes through the HO
    stage wrapper once per field (with the LO output asked for once) and
    through neither geom_conv nor a CG solve."""
    import remhos_torch.operator as op
    dim, shape = 3, (3, 2, 2)
    args = (dim, shape, (0.0,) * dim, (1.0,) * dim, (False,) * dim)
    td = build_discretization(make_cartesian_mesh(*args), 3)
    x0 = td.mesh.x
    adv = Advection(td, SolverConfig(problem=10, ho=3, lo=5, fct=2, pa=True,
                                     product_sync=True), x0,
                    0.1 * np.sin(x0), dtype=torch.float64, device="cpu")
    rng = np.random.default_rng(8)
    S = t64(np.stack([rng.random((12, 64)), rng.random((12, 64))]))
    calls = []
    real = {n: getattr(op, n) for n in ("stage_ho", "geom_conv",
                                        "wdet_kernel", "mega_stage")}

    def spy(name):
        def f(*a, **k):
            calls.append((name, k.get("with_lo")))
            return real[name](*a, **k)
        return f

    for n in real:
        setattr(op, n, spy(n))
    try:
        adv.stage_function()(T_STAGE, DT, S)
    finally:
        for n, f in real.items():
            setattr(op, n, f)
    assert calls == [("stage_ho", True), ("stage_ho", False)]
    assert adv.cg_stats == dict(solves=0, iterations=0)
