"""Driver: setup, time loop and reporting (the remhos() entry equivalent).

The port of `remhos_tpu.driver` for one device, a structured mesh, the remap
problems 10-17 and the partial-assembly solver families (`-ho 2|3
-lo 0|3|4|5 -fct 0|2 -pa`; `operator.py` picks the fused or the non-fused
stage): `run(cfg) -> RunResult`, whose `final_mass_u` plays the role of the C
entry's out-parameter (remhos.cpp:210).

The Python loop handles the adaptive-dt rollback (remhos.cpp:1178-1197), the
-vb raise and logging. With -vb or -dtc 1 it fetches the step's aux channel
once per step; without them it fetches nothing, and the device runs ahead of
the host.

Standard RK in float32 runs the production numerics: the Kahan-compensated
combine and, every step, the FULL f64 mass closure pinning <ml(t), u + c> to
the t = 0 invariant (driver.py:227-273 of the reference). `bench.py` runs
the incremental closure instead; each mirrors its own counterpart.

Not ported yet, and raising NotImplementedError with their ROADMAP.md item
when asked for: sharding, checkpoints, `vis`, `visit`, `save`,
`profile_dir`, and the transport problems with their inflow projection,
steady-state stopping and L1 error.
"""

from __future__ import annotations

import dataclasses
import math
import time

import numpy as np
import torch

from . import geometry as geo
from . import problems as prob
from . import resolve_device, synchronize
from . import steppers
from . import sync as syncm
from .config import RunConfig, RunResult
from .discretization import build_discretization
from .mesh import default_mesh, load_mesh
from .operator import Advection, SolverConfig


def project_bernstein(x_nodes, Bm_at_unodes, func):
    """MFEM PositiveFiniteElement::Project: function values at the
    closed-uniform nodes become the Bernstein dofs (remhos.cpp:883).
    Returns (dofs[E, nd], x_unodes[E, nd, dim])."""
    B = torch.as_tensor(Bm_at_unodes, dtype=x_nodes.dtype,
                        device=x_nodes.device)
    x_unodes = torch.einsum("end,mn->emd", x_nodes, B)
    return func(x_unodes), x_unodes


def integrate_mesh_velocity(x0, problem, bb_min, bb_max, t_final, dt):
    """Remap pseudo-velocity v = x_final - x0: the mesh nodes integrated to
    t_final with the analytic velocity by forward Euler (remhos.cpp:560-584).

    The step list is computed on the host with the reference's own float
    arithmetic (including its final-step quirk), then a plain loop runs on
    the device of x0."""
    t, dts = 0.0, []
    while t < t_final:
        t += dt
        dts.append(min(dt, t_final - t))
    x = x0
    vc = prob.velocity_function(problem, x, bb_min, bb_max)
    for dti in dts:
        x = x + dti * vc
        vc = prob.velocity_function(problem, x, bb_min, bb_max)
    return x - x0


def _cfl_dt(mesh, problem, order):
    """CFL-based initial dt for -dt < 0 (remhos.cpp:537-553)."""
    h = mesh.element_sizes()
    centers = torch.as_tensor(mesh.element_centers(), dtype=torch.float64)
    v = prob.velocity_function(problem, centers, mesh.bb_min,
                               mesh.bb_max).numpy()
    speed = np.sqrt((v * v).sum(axis=1) + 1e-14)
    return float(np.min(0.25 * h / speed))


def _echo_options(cfg: RunConfig):
    """Full option echo for run-log reproducibility (the reference's
    OptionsParser::PrintOptions, remhos.cpp:340)."""
    print("Options used:")
    for f in dataclasses.fields(cfg):
        print(f"   --{f.name} {getattr(cfg, f.name)}")


def _unported(cfg: RunConfig):
    """The ROADMAP.md item an option of `cfg` needs, or None."""
    if cfg.n_shards > 1 or cfg.shard_grid is not None or cfg.dcn:
        return "sharding over several devices (Queue 1, item 13)"
    if cfg.checkpoint_path or cfg.checkpoint_steps or cfg.resume:
        return "checkpoint and resume (Queue 1, item 11)"
    if cfg.vis or cfg.visit or cfg.save:
        return "vis, visit and save output (Queue 1, item 14)"
    if cfg.profile_dir:
        return "the profiler trace of the loop (Queue 1, item 14)"
    if prob.exec_mode_of(cfg.problem) != 1:
        return ("transport problems, with their inflow projection, "
                "steady-state stopping and L1 error (Queue 1, item 9)")
    return None


def build_operator(cfg: RunConfig):
    """(adv, dt): the operator of a run on its mesh, with the remap mesh
    velocity in `adv.v_nodes`, and the run's initial dt. `run` starts here;
    callers that want the stage functions, the kernels' tables or the nodes
    of a configuration without running it do too."""
    why = _unported(cfg)
    if why is not None:
        raise NotImplementedError(
            f"remhos_torch.driver.run: {why} is not ported yet (ROADMAP.md)")
    device = resolve_device(cfg.device)
    dtype = torch.float32 if cfg.dtype == "float32" else torch.float64
    f64 = torch.float64

    # --- mesh ---
    if cfg.mesh == "default":
        mesh = default_mesh(cfg.dim, cfg.n_shards, cfg.elem_per_shard,
                            cfg.mesh_order)
        mesh = mesh.refine(cfg.rp_levels)
    else:
        mesh = load_mesh(cfg.mesh, cfg.rs_levels + cfg.rp_levels,
                         cfg.mesh_order)
    disc = build_discretization(mesh, cfg.order)

    dt = cfg.dt
    if dt < 0.0:
        dt = _cfl_dt(mesh, cfg.problem, cfg.order)

    # --- remap mesh velocity (f64, then cast to the working dtype) ---
    x0_64 = torch.as_tensor(mesh.x, dtype=f64, device=device)
    v_nodes = integrate_mesh_velocity(x0_64, cfg.problem, mesh.bb_min,
                                      mesh.bb_max, cfg.t_final,
                                      dt).to(dtype)

    # --- solver config / operator ---
    scfg = SolverConfig(problem=cfg.problem, ho=cfg.ho, lo=cfg.lo,
                        fct=cfg.fct, mono=cfg.mono, pa=cfg.pa,
                        ode_solver=cfg.ode_solver,
                        bounds_type=cfg.bounds_type,
                        dt_control=cfg.dt_control,
                        product_sync=cfg.product_sync,
                        smth_ind=cfg.smth_ind,
                        verify_bounds=cfg.verify_bounds,
                        use_masks=cfg.use_masks)
    return Advection(disc, scfg, x0_64.to(dtype), v_nodes, dtype=dtype,
                     device=device), dt


def run(cfg: RunConfig) -> RunResult:
    if cfg.verbose:
        _echo_options(cfg)
    adv, dt = build_operator(cfg)
    device, dtype, f64 = adv.device, adv.dtype, torch.float64
    disc, mesh = adv.disc, adv.disc.mesh
    x0_nodes, v_nodes = adv.x0_nodes, adv.v_nodes
    t_final = 1.0   # pseudo-time convention (remhos.cpp:1128-1134)

    # --- initial condition (from the working-dtype nodes, in f64) ---
    u0, x_unodes = project_bernstein(
        x0_nodes.to(f64), disc.Bm_at_unodes,
        lambda x: prob.u0_function(cfg.problem, x, mesh.bb_min, mesh.bb_max))
    fields = [u0]
    if cfg.product_sync:
        active_el, _ = syncm.bool_indicators(u0)
        s0 = torch.where(active_el[:, None], prob.s0_function(x_unodes), 0.0)
        fields.append(u0 * s0)
    S = torch.stack(fields).to(dtype)

    # --- initial masses (remhos.cpp:1072-1081) ---
    # The reporting sums run in f64 whatever the working precision (the
    # reference's masses are f64): in f32 this measures the TRAJECTORY's
    # conservation, not the round-off of the reporting reduction.
    masses = adv.lumped_mass(0.0)

    def _mass(ml, field, comp=None):
        s = field.to(f64) if comp is None else field.to(f64) + comp.to(f64)
        return float((ml.to(f64) * s).sum())

    mass0_u = _mass(masses, S[0])
    mass0_us = _mass(masses, S[1]) if cfg.product_sync else 0.0

    # --- stepper ---
    use_closure = False
    if cfg.ode_solver <= 10:
        # f32 production numerics: Kahan-compensated RK combine + per-step
        # conservative mass closure. The closure is only valid where the
        # SCHEME conserves <ml(t), u> to round-off: remap with RK3/4/6
        # (the GCL's temporal error is O(dt^4) per step; forward Euler and
        # RK2 drift at O(dt^2) and O(dt^3)).
        use_closure = (dtype == torch.float32 and cfg.closure
                       and cfg.ode_solver in (3, 4, 6))
        step = steppers.make_rk_step(adv.stage_function(), cfg.ode_solver,
                                     compensated=use_closure)
        if use_closure:
            mlk, sig = geo.lumped_mass_poly(x0_nodes, v_nodes, disc)
            mlk32 = mlk.to(dtype)
            # invariant target: the f32-cast initial state's mass in the
            # closure's own f32-mlk metric, so the loop starts closed
            m0 = float(mlk32[0].to(f64).reshape(-1)
                       @ S[0].to(f64).reshape(-1))
            closure = steppers.make_mass_closure(mlk32, sig.cpu().numpy(),
                                                 m0)
    else:
        step = steppers.make_idp_step(
            adv.mult_unlimited, adv.limit_mult, cfg.ode_solver,
            compute_mask=adv.compute_mask, use_masks=cfg.use_masks,
            geometry=adv.geometry)

    # --- time loop (remhos.cpp:1146-1330) ---
    t = 0.0
    ti = 0
    ti_total = 0
    done = False
    check_global = (cfg.verify_bounds and cfg.problem % 10 not in (6, 7)
                    and (cfg.lo != 0 or cfg.mono != 0))
    if check_global:
        u_max_glob, u_min_glob = float(S[0].max()), float(S[0].min())
    fetch_aux = cfg.verify_bounds or cfg.dt_control != 0
    C = torch.zeros_like(S) if use_closure else None
    inj_acc = torch.zeros((), dtype=f64, device=device)
    synchronize(device)
    wall0 = time.perf_counter()
    while not done:
        dt_real = min(dt, t_final - t)
        if use_closure:
            S_new, C_new, aux = step(S, C, t, dt_real)
        else:
            S_new, aux = step(S, t, dt_real)   # aux = [dt_ratio, -violations]
        ti += 1
        ti_total += 1
        if fetch_aux:
            # the step's one fetch from the device
            ratio, neg_viol = (aux.tolist() if aux is not None
                               else (math.inf, 0.0))
        if cfg.verify_bounds and -neg_viol > 0:
            # dof-level stage checks accumulated inside the step
            # (check_violation remhos.cpp:1824-1837 + the product
            # solver's own checks); raise like the reference's MFEM_ABORT
            raise RuntimeError(
                f"-vb: {int(-neg_viol)} dof bounds violation(s) inside the "
                f"RK stages of step {ti} (t={t:g}); see "
                f"remhos_torch/verify.py")
        if cfg.dt_control != 0:
            if ratio < 1.0:
                if cfg.verbose:
                    print(f"Repeat / decrease dt: {dt_real} --> {0.85 * dt}")
                ti -= 1
                dt = 0.85 * dt
                if dt < 1e-12:
                    raise RuntimeError("The time step crashed!")
                continue
            elif ratio > 1.25:
                dt *= 1.02
        S = S_new
        t += dt_real
        if use_closure:
            # pin <ml(t), u + c> to the t=0 invariant; the injected-mass
            # accumulator stays on the device (no per-step fetch) and is
            # reported at exit, so the closure can never silently absorb
            # a conservation bug
            c_u, deficit = closure(S[0], C_new[0], t)
            inj_acc = inj_acc + deficit.abs()
            C = C_new
            C[0] = c_u

        done = t >= t_final - 1e-8 * dt
        if check_global:
            # global monotonicity assertions (remhos.cpp:1219-1260)
            u_max_new, u_min_new = torch.stack([S[0].max(),
                                                S[0].min()]).tolist()
            if u_max_new > u_max_glob + 1e-10 or \
                    u_min_new < u_min_glob - 1e-10:
                raise RuntimeError(
                    f"Bounds violation at step {ti}: "
                    f"[{u_min_glob}, {u_max_glob}] -> "
                    f"[{u_min_new}, {u_max_new}]")
            u_max_glob, u_min_glob = u_max_new, u_min_new
        if ti_total == cfg.max_tsteps:
            done = True
        if cfg.verbose and (done or ti % cfg.vis_steps == 0):
            print(f"time step: {ti}, time: {t:.6g}, dt: {dt:.6g}, "
                  f"residual: 0")
    synchronize(device)
    wall = time.perf_counter() - wall0

    # --- final mass / max (remhos.cpp:1382-1436) ---
    ml_final = adv.lumped_mass(t)
    mass_u = _mass(ml_final, S[0], C[0] if use_closure else None)
    max_u = float(S[0].max())
    res = RunResult(final_mass_u=mass_u, max_u=max_u,
                    mass_loss_u=abs(mass0_u - mass_u),
                    steps=ti, steps_total=ti_total, t=t, dt=dt,
                    mass_closure_injected_rel=(
                        float(inj_acc) / max(abs(mass0_u), 1e-300)
                        if use_closure else 0.0),
                    timers={"wall_s": wall})
    res.cg_solves = adv.cg_stats["solves"]
    res.cg_iterations = adv.cg_stats["iterations"]
    if cfg.product_sync:
        mass_us = _mass(ml_final, S[1], C[1] if use_closure else None)
        s, _, _ = syncm.compute_ratio(S[1], S[0])
        res.final_mass_us = mass_us
        res.mass_loss_us = abs(mass0_us - mass_us)
        res.max_s = float(s.max())

    if cfg.verbose:
        if device.type == "cuda":
            # the reference's memory high-water report (remhos.cpp:1511-21)
            print(f"Device memory high water mark: "
                  f"{torch.cuda.max_memory_allocated(device) / 2**30:.3f} GB")
        print(f"Final mass u:  {mass_u:.10g}")
        print(f"Max value u:   {max_u:.10g}")
        print(f"Mass loss u:   {res.mass_loss_u:.6g}")
        if use_closure:
            print(f"Mass closure injected (rel): "
                  f"{res.mass_closure_injected_rel:.6g}")
        if cfg.product_sync:
            print(f"Final mass us: {res.final_mass_us:.10g}")
            print(f"Max value s:   {res.max_s:.10g}")
            print(f"Mass loss us:  {res.mass_loss_us:.6g}")
    return res
