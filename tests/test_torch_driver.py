"""remhos_torch.driver.run against remhos_tpu.driver.run on the CPU.

Both drivers get the same RunConfig fields (the JAX side with
`use_pallas=True`, whose Pallas kernels run in interpret mode; the port
with `device="cpu"`, where its kernel wrappers run their plain versions),
on inline-quad refined once (8x8 elements, p=3, mesh order 2) for a few
steps. Tolerances in f64: `final_mass_u`, `final_mass_us` and `max_u`
<= 1e-10 relative, `steps` and `steps_total` equal, `dt` <= 1e-14 relative.
`max_s` <= 1e-10 relative too, except where noted: it is the maximum of
us/u over every dof with u > 1e-12, so a last-digit difference in a dof
with u ~ 1e-10 shows in its sixth digit. In f32 (the closure on): <= 2e-3,
the JAX f32 kernels' bf16x3 products against true f32 products; `max_s` is
not compared there (dofs at f32 round-off level count as active and their
ratio is noise, on both sides).

What the two drivers share that may surprise:
- with -lo 5, -vb trips wherever the element average of the unlimited HO
  update leaves the dof bounds (problem 14 at any dt, problem 10 at a large
  dt); both raise with the same count. Problem 10 at dt = 5e-4 is clean;
- in f32, -dtc 1 never accepts a step: the dt estimate's threshold on du
  (1e-12) is below f32 round-off, every dt is rejected, and both end in
  "The time step crashed!".
"""

import re

import pytest

from remhos_tpu import driver as jdriver
from remhos_tpu.config import RunConfig as JConfig

from remhos_torch import driver
from remhos_torch.config import RunConfig

BASE = dict(mesh="inline-quad", rs_levels=1, order=3, ho=3, lo=5, fct=2,
            pa=True, t_final=0.75, dt=0.005, verbose=False)


def _both(**kw):
    cfg = dict(BASE, **kw)
    return (jdriver.run(JConfig(use_pallas=True, **cfg)),
            driver.run(RunConfig(device="cpu", **cfg)))


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-300)


def _check(rj, rt, tol, max_s_tol=None, dt_tol=1e-14):
    assert (rt.steps, rt.steps_total) == (rj.steps, rj.steps_total)
    assert _rel(rt.dt, rj.dt) <= dt_tol and _rel(rt.t, rj.t) <= 1e-13
    assert _rel(rt.final_mass_u, rj.final_mass_u) <= tol
    assert _rel(rt.max_u, rj.max_u) <= tol
    if rj.final_mass_us:
        assert _rel(rt.final_mass_us, rj.final_mass_us) <= tol
        if max_s_tol is not None:
            assert _rel(rt.max_s, rj.max_s) <= max_s_tol
    else:
        assert rt.final_mass_us == 0.0 and rt.max_s == 0.0


def test_product_remap_idp2():
    """inline-quad -p 14 -rs 1 -o 3 -ho 3 -lo 5 -fct 2 -ps -s 12, 4 steps."""
    rj, rt = _both(problem=14, product_sync=True, ode_solver=12,
                   max_tsteps=4)
    _check(rj, rt, 1e-10, max_s_tol=1e-10)
    assert rt.steps == 4 and rt.mass_closure_injected_rel == 0.0
    assert abs(rt.mass_loss_us - rj.mass_loss_us) <= 1e-12


def test_product_remap_rk3_vb_trips_alike():
    """The same with -s 3 -vb: the MassBasedAvg LO check fires in the
    first step, with the same violation count on both sides."""
    cfg = dict(BASE, problem=14, product_sync=True, ode_solver=3,
               verify_bounds=True, max_tsteps=4)
    msgs = []
    for run, c in ((jdriver.run, JConfig(use_pallas=True, **cfg)),
                   (driver.run, RunConfig(device="cpu", **cfg))):
        with pytest.raises(RuntimeError, match="-vb") as e:
            run(c)
        msgs.append(re.match(r"-vb: (\d+) dof bounds violation\(s\) inside "
                             r"the RK stages of step (\d+)", str(e.value)))
    assert msgs[0] and msgs[1]
    assert msgs[0].groups() == msgs[1].groups()
    assert int(msgs[1].group(1)) > 0 and msgs[1].group(2) == "1"


@pytest.mark.parametrize("ode_solver", [3, 13])
def test_product_remap_vb_clean(ode_solver):
    """-ps -vb on problem 10 at dt = 5e-4: every stage check passes at the
    reference's 1e-12, and the global monotonicity check runs."""
    rj, rt = _both(problem=10, product_sync=True, ode_solver=ode_solver,
                   verify_bounds=True, dt=0.0005, max_tsteps=3)
    _check(rj, rt, 1e-10, max_s_tol=1e-10)
    assert rt.steps == 3 and rt.max_s <= 3.0 + 1e-8


def test_dt_control_rolls_back():
    """-dtc 1 from a dt that is too large: both roll back the same attempts
    (steps_total > steps) and arrive at the same dt."""
    rj, rt = _both(problem=10, product_sync=True, ode_solver=3,
                   dt_control=1, dt=0.0007, max_tsteps=6)
    assert rt.steps_total > rt.steps >= 1
    _check(rj, rt, 1e-10, max_s_tol=1e-10)
    assert rt.dt < 0.0007


def test_f32_closure_run():
    """One f32 run with the Kahan combine and the full closure every step
    (two fields, so the non-mega stage), against the JAX f32 driver."""
    rj, rt = _both(problem=14, product_sync=True, ode_solver=3,
                   dtype="float32", max_tsteps=4)
    _check(rj, rt, 2e-3)
    assert rt.mass_closure_injected_rel > 0.0
    assert rt.mass_closure_injected_rel < 1e-5
    assert rj.mass_closure_injected_rel < 1e-5


def test_f32_dt_control_crashes_alike():
    cfg = dict(BASE, problem=10, product_sync=True, ode_solver=3,
               dt_control=1, dtype="float32", dt=0.0007, t_final=0.7,
               max_tsteps=6)
    for run, c in ((jdriver.run, JConfig(use_pallas=True, **cfg)),
                   (driver.run, RunConfig(device="cpu", **cfg))):
        with pytest.raises(RuntimeError, match="time step crashed"):
            run(c)


def test_single_field_mega_path_and_cfl_dt():
    """One field without -vb or dt control goes through the mega stage; dt
    < 0 takes the CFL estimate, which agrees to round-off."""
    rj, rt = _both(problem=10, ode_solver=3, dt=-1.0, max_tsteps=3)
    _check(rj, rt, 1e-10, dt_tol=1e-13)
    assert rt.dt > 0 and rt.max_s == 0.0


def test_default_mesh_3d_rk6():
    """-m default in 3D (2x2x2 elements), RK6, LO-only and unlimited."""
    for kw in (dict(lo=5, fct=2, ode_solver=6), dict(lo=0, fct=0)):
        rj, rt = _both(**dict(mesh="default", dim=3, elem_per_shard=8,
                              problem=10, dt=0.01, max_tsteps=2, **kw))
        _check(rj, rt, 1e-10)


@pytest.mark.parametrize("kw,item", [
    (dict(n_shards=2), "item 13"), (dict(shard_grid=(2,)), "item 13"),
    (dict(checkpoint_path="x.npz", checkpoint_steps=1), "item 11"),
    (dict(resume=True), "item 11"), (dict(vis=True), "item 14"),
    (dict(visit=True), "item 14"), (dict(save=True), "item 14"),
    (dict(profile_dir="prof"), "item 14"), (dict(problem=4), "item 9"),
    (dict(problem=7), "item 9"), (dict(mesh="star.mesh"), "item 12"),
    (dict(mesh="periodic-segment"), "item 12"),
    (dict(lo=1), "item 10"), (dict(fct=4), "item 10"),
    (dict(pa=False), "item 10"), (dict(bounds_type=1), "Queue 2"),
    (dict(problem=18), "item 9")])
def test_unported_options_raise(kw, item):
    cfg = RunConfig(device="cpu",
                    **{**BASE, "problem": 10, "max_tsteps": 1, **kw})
    with pytest.raises(NotImplementedError, match="ROADMAP") as e:
        driver.run(cfg)
    assert item in str(e.value)


def test_device_none_means_cuda():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        driver.run(RunConfig(**dict(BASE, problem=10, max_tsteps=1)))
