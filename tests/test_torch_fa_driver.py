"""remhos_torch.driver.run on the assembled (FA) path and with `-bt 1`,
against remhos_tpu.driver.run on the CPU.

The cases are the FA cases of tests/test_driver.py (the flux-based and
penalty ones, and two 3D remap cases, are in
tests/test_torch_fa_driver_flux.py), with the same
configurations and lengths, plus the `-bt 1` mega stage on a small 3D
mesh. Tolerances in f64: final mass and max u <= 1e-12 relative, step
counts equal. The port's FA run is also held to its own PA run as
tests/test_driver.py holds the JAX package's (1e-7), and its f32 FA runs to
its f64 runs by tests/test_f32_goldens.py's rule. Configurations that are
not ported raise NotImplementedError naming their ROADMAP.md item; those
the JAX package rejects raise in both packages.
"""

import pytest

from remhos_tpu import driver as jdriver
from remhos_tpu.config import RunConfig as JConfig

from remhos_torch import driver, ops
from remhos_torch.config import RunConfig
from torch_items import check_item_case
from torch_threads import one_torch_thread  # noqa: F401

TRANSPORT = dict(mesh="periodic-square", problem=4, verbose=False)
PACMAN = dict(mesh="inline-quad", problem=14, rs_levels=1, order=3,
              t_final=0.75, verbose=False)


def _both(**kw):
    return (jdriver.run(JConfig(use_pallas=kw.get("pa", False), **kw)),
            driver.run(RunConfig(device="cpu", **kw)))


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-300)


def _check(rj, rt, tol=1e-12):
    assert (rt.steps, rt.steps_total) == (rj.steps, rj.steps_total)
    assert _rel(rt.final_mass_u, rj.final_mass_u) <= tol
    assert _rel(rt.max_u, rj.max_u) <= tol
    if rj.final_mass_us:
        assert _rel(rt.final_mass_us, rj.final_mass_us) <= tol
        assert _rel(rt.max_s, rj.max_s) <= 1e-10


@pytest.mark.parametrize("name,kw", [
    ("discrete_upwind_fctproject",
     dict(TRANSPORT, rs_levels=2, order=2, dt=0.005, t_final=0.05, ho=3,
          lo=1, fct=4)),
    ("neumann_ho",
     dict(TRANSPORT, rs_levels=1, order=2, dt=0.002, t_final=0.02, ho=1,
          lo=3, fct=2)),
    ("cg_ho",
     dict(TRANSPORT, rs_levels=1, order=2, dt=0.002, t_final=0.02, ho=2,
          lo=5, fct=2)),
    ("sparsity_bounds",
     dict(TRANSPORT, rs_levels=2, order=3, dt=0.005, t_final=0.05, ho=3,
          lo=5, fct=2, bounds_type=1)),
    ("auto_dt",
     dict(PACMAN, dt=-1.0, max_tsteps=12, ho=3, lo=5, fct=4, bounds_type=1,
          dt_control=1)),
    ("product_fct_project_idp3",
     dict(PACMAN, dt=0.005, max_tsteps=10, ho=3, lo=5, fct=4,
          product_sync=True, ode_solver=13))])
def test_fa_matches_jax(name, kw):
    rj, rt = _both(**kw)
    _check(rj, rt)
    assert rt.mass_closure_injected_rel == 0.0
    if kw["ho"] == 2:
        assert rt.cg_solves > 0 and rt.cg_iterations > rt.cg_solves


def test_cg_and_local_inverse_agree():
    """tests/test_driver.py::test_cg_ho's second half: -ho 2 and -ho 3 give
    the same run (the DG mass solve is block-diagonal)."""
    kw = dict(TRANSPORT, rs_levels=1, order=2, dt=0.002, t_final=0.02,
              lo=5, fct=2, device="cpu")
    r2 = driver.run(RunConfig(ho=2, **kw))
    r3 = driver.run(RunConfig(ho=3, **kw))
    assert abs(r2.final_mass_u - r3.final_mass_u) < 1e-10
    assert abs(r2.max_u - r3.max_u) < 1e-8


def test_pa_equals_fa_remap():
    """The port's FA run against its own PA run (the fused stage), as
    tests/test_driver.py holds the JAX package's: the PA mass inverse is a
    CG to its tolerance, the FA one a Cholesky solve."""
    kw = dict(PACMAN, dt=0.0015, max_tsteps=10, ho=3, lo=5, fct=2,
              device="cpu")
    r_fa = driver.run(RunConfig(**kw))
    r_pa = driver.run(RunConfig(pa=True, **kw))
    assert abs(r_fa.final_mass_u - r_pa.final_mass_u) < 1e-7
    assert abs(r_fa.max_u - r_pa.max_u) < 1e-7


def test_bt1_mega_path_3d():
    """-ho 3 -lo 5 -fct 2 -bt 1 -pa in remap on 2x2x2 elements: the mega
    stage with per-dof sparsity bounds (its plain version here)."""
    ops.reset_launch_counts()
    rj, rt = _both(mesh="default", dim=3, elem_per_shard=8, problem=10,
                   order=3, dt=0.01, t_final=0.7, max_tsteps=3, ho=3, lo=5,
                   fct=2, bounds_type=1, pa=True, verbose=False)
    _check(rj, rt)
    assert ops.launch_counts()["mega_stage"] == 0        # CPU
    assert rt.max_u <= 1.0 + 1e-10


@pytest.mark.parametrize("kw", [
    dict(ho=3, lo=5, fct=2),
    dict(mesh="periodic-square", problem=5, ho=3, lo=1, fct=1, dt=0.01,
         t_final=0.1),
    dict(mesh="periodic-square", problem=5, ho=3, lo=3, fct=4, dt=0.01,
         t_final=0.1, ode_solver=12),
    dict(mesh="periodic-square", problem=0, ho=1, lo=2, fct=2, dt=0.01,
         t_final=0.1)])
def test_f32_fa_tracks_f64(kw):
    """tests/test_f32_goldens.py's rule for the FA rows: the f32 run
    conserves to f32 round-off and tracks the f64 run (final mass 1e-5
    relative, max u 1e-3)."""
    base = dict(PACMAN, rs_levels=1, order=3, dt=0.0015, max_tsteps=8,
                device="cpu")
    base.update(kw)
    r64 = driver.run(RunConfig(**base))
    r32 = driver.run(RunConfig(dtype="float32", **base))
    assert r32.mass_loss_u < max(1e-5, 50 * r64.mass_loss_u)
    assert _rel(r32.final_mass_u, r64.final_mass_u) < 1e-5
    assert abs(r32.max_u - r64.max_u) < 1e-3


@pytest.mark.parametrize("kw,item", [
    (dict(mono=1, save=True), "Queue 1, item 9"),
    (dict(smth_ind=1, fct=3, mesh="disc-nurbs"), "Queue 1, item 8"),
    (dict(mesh="periodic-segment", problem=0, n_shards=2),
     "Queue 1, item 10"),
    (dict(mesh="star.mesh"), "Queue 1, item 8"),
    (dict(n_shards=2), "Queue 1, item 10")])
def test_unported_fa_options_raise(kw, item, tmp_path, monkeypatch):
    """The case's item decides what it checks (`torch_items`): an open
    item raises NotImplementedError naming it; closed items 8 and 9
    raise the missing-file error or run and write their output."""
    monkeypatch.chdir(tmp_path)
    cfg = RunConfig(device="cpu", **{**PACMAN, "dt": 0.0015, "ho": 3,
                                     "lo": 1, "fct": 1, "max_tsteps": 1,
                                     **kw})
    check_item_case(cfg, item)


@pytest.mark.parametrize("kw,jax_error", [
    (dict(lo=1, pa=True), ValueError), (dict(lo=2, pa=True), ValueError),
    (dict(ho=1, pa=True), KeyError), (dict(fct=1, pa=True), KeyError),
    (dict(fct=4, pa=True), KeyError), (dict(ho=0, fct=2), ValueError),
    (dict(lo=0, fct=2), ValueError)])
def test_combinations_jax_rejects_raise(kw, jax_error):
    """The JAX package raises at its first stage (ValueError, or KeyError
    where its PA stage has no assembled matrix); the port raises
    ValueError, with the JAX package's message where it has one."""
    cfg = dict(PACMAN, dt=0.0015, ho=3, lo=5, fct=2, max_tsteps=1)
    cfg.update(kw)
    with pytest.raises(jax_error) as ej:
        jdriver.run(JConfig(**cfg))
    with pytest.raises(ValueError) as et:
        driver.run(RunConfig(device="cpu", **cfg))
    if jax_error is ValueError:
        assert str(et.value) == str(ej.value)
