"""remhos_torch.driver.run against remhos_tpu.driver.run on the non-fused PA
path, on the CPU.

Both drivers get the same RunConfig fields (the JAX side with
`use_pallas=True`, whose Pallas kernels run in interpret mode; the port with
`device="cpu"`, where its kernel wrappers run their plain versions) on
inline-quad refined once (8x8 elements, p=3, mesh order 2) or a 2x2x2 3D
mesh, for a few steps. Tolerances in f64: final masses <= 1e-12 relative,
`max_u` <= 1e-10 relative, step counts equal. In f32 (the closure on):
<= 2e-3, the JAX f32 products against true f32 products, as in
tests/test_torch_driver.py.
"""

import pytest

from remhos_tpu import driver as jdriver
from remhos_tpu.config import RunConfig as JConfig

from remhos_torch import driver
from remhos_torch.config import RunConfig

BASE = dict(mesh="inline-quad", rs_levels=1, order=3, problem=10, fct=2,
            pa=True, t_final=0.75, dt=0.002, verbose=False)


def _both(**kw):
    cfg = dict(BASE, **kw)
    return (jdriver.run(JConfig(use_pallas=True, **cfg)),
            driver.run(RunConfig(device="cpu", **cfg)))


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-300)


def _check(rj, rt, mass_tol, max_tol):
    assert (rt.steps, rt.steps_total) == (rj.steps, rj.steps_total)
    assert _rel(rt.t, rj.t) <= 1e-13 and _rel(rt.dt, rj.dt) <= 1e-14
    assert _rel(rt.final_mass_u, rj.final_mass_u) <= mass_tol
    assert _rel(rt.max_u, rj.max_u) <= max_tol
    if rj.final_mass_us:
        assert _rel(rt.final_mass_us, rj.final_mass_us) <= mass_tol
    else:
        assert rt.final_mass_us == 0.0 and rt.max_s == 0.0


def test_product_remap_ho3_lo3():
    """-ho 3 -lo 3 -fct 2 -pa -ps, RK3, 4 steps, f64."""
    rj, rt = _both(ho=3, lo=3, product_sync=True, max_tsteps=4)
    _check(rj, rt, 1e-12, 1e-10)
    assert rt.steps == 4 and rt.mass_closure_injected_rel == 0.0
    # the loss is the scheme's (RK3 on a moving mesh), equal on both sides
    assert abs(rt.mass_loss_u - rj.mass_loss_u) <= 1e-13
    assert abs(rt.mass_loss_us - rj.mass_loss_us) <= 1e-13
    assert _rel(rt.max_s, rj.max_s) <= 1e-8


def test_product_remap_ho3_lo3_f32_closure():
    """The same in f32: the Kahan combine and the full closure every step."""
    rj, rt = _both(ho=3, lo=3, product_sync=True, max_tsteps=4,
                   dtype="float32")
    _check(rj, rt, 2e-3, 2e-3)
    assert 0.0 < rt.mass_closure_injected_rel < 1e-5
    assert rj.mass_closure_injected_rel < 1e-5
    assert rt.mass_loss_u <= 1e-6 * rt.final_mass_u


@pytest.mark.parametrize("mesh_kw", [
    dict(), dict(mesh="default", dim=3, elem_per_shard=8, dt=0.01)])
def test_remap_ho2_lo4(mesh_kw):
    """-ho 2 -lo 4 -fct 2 -pa: the Bernstein CG and the subcell weights, on
    the 2D mesh and on 2x2x2 elements in 3D."""
    rj, rt = _both(ho=2, lo=4, max_tsteps=3, **mesh_kw)
    _check(rj, rt, 1e-12, 1e-10)
    assert rt.steps == 3 and abs(rt.mass_loss_u - rj.mass_loss_u) <= 1e-13


@pytest.mark.parametrize("lo", [3, 4])
def test_idp_rk_vb_clean(lo):
    """IDP-RK2 with -vb on the residual-distribution LO solutions: every
    stage check passes at the reference's 1e-12 on both sides, and the
    global monotonicity check runs."""
    rj, rt = _both(ho=3, lo=lo, product_sync=True, ode_solver=12,
                   verify_bounds=True, dt=0.0005, max_tsteps=3)
    _check(rj, rt, 1e-12, 1e-10)
    assert rt.steps == 3 and rt.max_s <= 3.0 + 1e-8


def test_dt_control_lo3():
    """-dtc 1 from a dt that is too large: the same attempts roll back."""
    rj, rt = _both(ho=3, lo=3, dt_control=1, dt=0.05, max_tsteps=8)
    assert rt.steps_total > rt.steps >= 1 and rt.dt < 0.05
    _check(rj, rt, 1e-12, 1e-10)


@pytest.mark.parametrize("kw,item", [
    (dict(lo=1), "item 10"), (dict(lo=2), "item 10"),
    (dict(fct=1), "item 10"), (dict(fct=3), "item 10"),
    (dict(fct=4), "item 10"), (dict(ho=1), "item 10"),
    (dict(ho=0, lo=3), "item 10"), (dict(mono=1), "item 10"),
    (dict(lo=4, mono=2), "item 10"), (dict(smth_ind=1), "item 10"),
    (dict(lo=3, pa=False), "item 10"), (dict(lo=3, problem=4), "item 9"),
    (dict(lo=3, n_shards=2), "item 13"),
    (dict(lo=3, mesh="periodic-segment"), "item 12"),
    (dict(lo=4, mesh="star.mesh"), "item 12"),
    (dict(lo=3, bounds_type=1), "Queue 2")])
def test_unported_options_still_raise(kw, item):
    cfg = RunConfig(device="cpu", **{**BASE, "ho": 3, "lo": 5,
                                     "max_tsteps": 1, **kw})
    with pytest.raises(NotImplementedError, match="ROADMAP") as e:
        driver.run(cfg)
    assert item in str(e.value)
