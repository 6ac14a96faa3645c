"""Driver: setup, time loop and reporting (the remhos() entry equivalent).

The port of `remhos_tpu.driver` for one device, a structured 1D, 2D or 3D
mesh or a general quad or hex mesh read from an MFEM file (`umesh.py`,
`umesh3d.py`, `nurbs.py`), the transport problems 0-7, the remap problems
10-17 and the solver
families `-ho 1|2|3 -lo 0-5 -fct 0-4 -bt 0|1`, the monolithic `-mono 1|2`
and the smoothness indicators `-si 1|2`, assembled or with `-pa` (in 1D
always assembled; `operator.py` picks the fused, the non-fused or the
assembled stage):
`run(cfg) -> RunResult`, whose `final_mass_u` plays the role of the C
entry's out-parameter (remhos.cpp:210).

Each step of the loop is `advance(step, S, t, dt)`: the step and the mass
closure, on the device; `advance(..., n_steps)` runs K steps of a built
operator, as the benchmark's phases do. Around it the Python loop handles
the adaptive-dt rollback (remhos.cpp:1178-1197), the -vb raise, the
steady-state stop of problems 6-8 (remhos.cpp:1276-1294), checkpoints and
logging. With -vb or -dtc 1 it fetches the step's aux channel once per
step, and the steady-state test fetches its residual; other runs fetch
nothing, and the device runs ahead of the host.

Standard RK in float32 runs the production numerics where the scheme
conserves mass (remap with RK3/4/6, transport on an all-periodic mesh): the
Kahan-compensated combine and, every step, the FULL f64 mass closure pinning
<ml(t), u + c> to the t = 0 invariant (driver.py:227-273 of the reference).
`bench.py` runs the incremental closure instead; each mirrors its own
counterpart.

Output (`vis.py`): `-visit` writes a VisIt collection at step 0 and every
`vis_steps`, `-vis` streams the GLVis windows then, and `-save` writes
meshHO_final.mesh, sltn_final.gf and sltn_final.npz at the end
(remhos_tpu/driver.py:304-318, 407-426, 485-500). `-prof` records the time
loop with torch.profiler into a Chrome trace under `profile_dir`
(`utils.trace.loop_profiler`). The trace carries the program's `remhos.*`
spans, each around one layer of a step (listed in `utils/trace.py`), and a
`remhos.sync` span at each wait for the device (the loop's aux fetch,
steady-state residual and monotonicity check among them); a layer's self
time is its span less its child spans (`utils.trace.loop_report` reads
device and idle time by the innermost span).

Sharded runs (remhos_tpu/driver.py:202-226): with `n_shards` > 1 or a
`shard_grid`, `run` runs in a process group of prod(shard_grid) ranks, one
block of elements each (`parallel/`). Under an initialized group (torchrun,
or `parallel.launch.spawn_run`) it joins it; with none it starts the ranks
itself (`spawn_run`; one shard runs in this process, in a group of one).
Every rank builds the global mesh, the mesh velocity and the initial state,
then keeps its own block and builds its own operator once. The f32 closure
is off, as in the JAX package; global sums, maxima and the steady-state
residual are reduced over the ranks; checkpoints are saved and resumed in
global element order (any shard count resumes any checkpoint); `-visit`,
`-vis` and `-save` write the fields gathered in global order, from rank 0.
Every rank returns the same RunResult. `-mono` and `-si` with shards raise
NotImplementedError, as the JAX package does.
"""

from __future__ import annotations

import dataclasses
import math
import time

import numpy as np
import torch

from . import checkpoint as ckpt
from . import geometry as geo
from . import problems as prob
from . import resolve_device, synchronize
from . import steppers
from . import sync as syncm
from . import vis as vism
from .config import RunConfig, RunResult
from .parallel import launch
from .discretization import build_discretization
from .mesh import default_mesh, load_mesh, registry_dim
from .operator import Advection, SolverConfig, solver_rejected
from .utils import trace as trc


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


def inflow_projection(problem, x0_nodes, disc):
    """The inflow values inflow[E, nd] of problems 6 and 7, None for the
    others (remhos.cpp:626-636). Problem 7 projects in two steps: the
    Gauss-Legendre nodal interpolant, evaluated at the Bernstein control
    points (remhos.cpp:628-635)."""
    if problem % 10 not in (6, 7):
        return None

    def T(a):
        return torch.as_tensor(a, dtype=x0_nodes.dtype,
                               device=x0_nodes.device)

    if problem == 7:
        x_gl = torch.einsum("end,mn->emd", x0_nodes, T(disc.Bm_at_glnodes))
        return torch.einsum("mk,ek->em", T(disc.T_gl_to_unif),
                            prob.inflow_function(problem, x_gl))
    x_un = torch.einsum("end,mn->emd", x0_nodes, T(disc.Bm_at_unodes))
    return prob.inflow_function(problem, x_un)


def advance(step, S, t, dt, n_steps=1, C=None, closure=None, inj=None):
    """`n_steps` steps of dt from the state S at (pseudo-)time t on a built
    operator, each as `run`'s time loop takes it: `step` is
    `steppers.make_rk_step`'s (or the IDP or sharded step), compensated
    where the Kahan compensation C is given; with `closure`
    (`steppers.make_mass_closure`) each step ends by pinning <ml(t), u + c>
    to the t = 0 invariant, and the mass it injects is added to `inj` on
    the device (no read-back, so the closure cannot silently absorb a
    conservation bug: `run` reports the sum at exit). Returns (S, C, t, inj,
    aux), aux the last step's side channel."""
    aux = None
    for _ in range(n_steps):
        if C is None:
            S, aux = step(S, t, dt)
        else:
            S, C, aux = step(S, C, t, dt)
        t += dt
        if closure is not None:
            c_u, deficit = closure(S[0], C[0], t)
            inj = inj + deficit.abs()
            C[0] = c_u
    return S, C, t, inj, aux


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


def _solver_config(cfg: RunConfig, dim: int) -> SolverConfig:
    """The operator's SolverConfig of a run configuration on a
    `dim`-dimensional mesh. In 1D the reference disables partial assembly
    (remhos.cpp:474-480): a -pa run there is an assembled one."""
    return SolverConfig(problem=cfg.problem, ho=cfg.ho, lo=cfg.lo,
                        fct=cfg.fct, mono=cfg.mono, pa=cfg.pa and dim > 1,
                        ode_solver=cfg.ode_solver,
                        bounds_type=cfg.bounds_type,
                        dt_control=cfg.dt_control,
                        product_sync=cfg.product_sync,
                        smth_ind=cfg.smth_ind,
                        verify_bounds=cfg.verify_bounds,
                        use_masks=cfg.use_masks, poly_bf16=cfg.poly_bf16)


def build_operator(cfg: RunConfig):
    """(adv, dt): the operator of a run on its mesh (in remap with the mesh
    velocity in `adv.v_nodes`, in transport with the inflow values of
    problems 6 and 7), and the run's initial dt. `run` starts here for an
    unsharded run; callers that want the stage functions, the kernels'
    tables or the nodes of a configuration without running it do too."""
    su = _setup(cfg)
    return Advection(su["disc"], _solver_config(cfg, su["mesh"].dim),
                     su["x0"], su["v"], dtype=su["dtype"],
                     device=su["device"], inflow=su["inflow"]), su["dt"]


def _setup(cfg: RunConfig) -> dict:
    """What every rank of a run builds alike: the global mesh and its
    discretization, the initial dt, the nodes x0 and (remap) the mesh
    velocity v in the working dtype, the inflow values of problems 6 and 7
    (None elsewhere), the device and the dtype."""
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
    x0_nodes = x0_64.to(dtype)
    v_nodes = None
    if prob.exec_mode_of(cfg.problem) == 1:
        v_nodes = integrate_mesh_velocity(x0_64, cfg.problem, mesh.bb_min,
                                          mesh.bb_max, cfg.t_final,
                                          dt).to(dtype)

    return dict(mesh=mesh, disc=disc, dt=dt, x0=x0_nodes, v=v_nodes,
                inflow=inflow_projection(cfg.problem, x0_nodes, disc),
                device=device, dtype=dtype)


def l1_error_parts(adv, u, problem, x):
    """[sum w |e|, sum w e^2, max |e|] (f64, on the device) of u[E, nd]
    against the exact solution of problem 4 (its initial condition) or 7
    (its inflow profile) on the nodes x, at the volume rule
    (remhos.cpp:1438-1470): the parts a sharded run reduces over ranks."""
    disc = adv.disc

    def T(a):
        return torch.as_tensor(a, dtype=x.dtype, device=x.device)

    vol = geo.volume_geometry(x, T(disc.Bm), T(disc.Gm))
    u_q = u @ adv.Bu.T
    if problem == 4:
        ex_q = prob.u0_function(problem, vol["x_q"], adv.bb_min, adv.bb_max)
    else:
        ex_q = prob.inflow_function(problem, vol["x_q"])
    wdet = adv.w_q[None, :] * vol["detJ"]
    err = (u_q - ex_q).abs()
    return torch.stack([(wdet * err).sum(), (wdet * err ** 2).sum(),
                        err.max()]).to(torch.float64)


class _Local:
    """The reductions and gathers of an unsharded run: the rank's own
    values (`_Shards` is the sharded run's)."""

    root = True
    staged_bytes = 0

    def sum(self, x):
        return float(x)

    def max_min(self, x):
        return tuple(torch.stack([x.max(), x.min()]).tolist())

    def max(self, x):
        return float(x.max())

    def live(self, a):
        return a

    def gather(self, S):
        return S


class _Shards(_Local):
    """A sharded run's reductions over the ranks: sums and extrema of the
    live rows (ghost rows excluded), and the state gathered in global
    element order on every rank."""

    def __init__(self, comm, perm, E_real):
        self.comm, self.E_real = comm, E_real
        self.root = comm.rank == 0
        n_loc = len(perm) // comm.size
        self.n_live = max(0, min(n_loc, E_real - comm.rank * n_loc))
        self.inv_perm = np.empty(E_real, dtype=np.int64)
        self.inv_perm[perm[:E_real]] = np.arange(E_real)

    @property
    def staged_bytes(self):
        return self.comm.staged_bytes

    def sum(self, x):
        return float(self.comm.all_sum(x.to(torch.float64).reshape(1)))

    def max_min(self, x):
        x = self.live(x)
        m = self.comm.all_max(torch.stack([x.max(), -x.min()]))
        return float(m[0]), -float(m[1])

    def max(self, x):
        return float(self.comm.all_max(self.live(x).max().reshape(1)))

    def live(self, a):
        """The rows of a per-element array [E_loc, ...] that are not
        ghosts."""
        return a[:self.n_live]

    def gather(self, S):
        """S[nf, E_loc, nd] of every rank, in global element order."""
        g = self.comm.all_gather(S.transpose(0, 1).contiguous())
        idx = torch.as_tensor(self.inv_perm, device=g.device)
        return g.index_select(0, idx).transpose(0, 1)


def _sharded_entry(cfg: RunConfig, grid):
    """None where this process runs its rank of the sharded configuration
    itself (a process group is initialized), else the RunResult of the run
    it starts: in a group of one in this process, or in prod(grid) spawned
    ranks. What the JAX package rejects raises here, before any rank
    starts."""
    if cfg.mono != 0 or cfg.smth_ind:
        raise NotImplementedError(
            "monolithic/smoothness-indicator solvers run single-shard "
            "(serial in the reference too, remhos_mono.cpp:285)")
    dim = cfg.dim if cfg.mesh == "default" else registry_dim(cfg.mesh)
    if dim is not None:           # a mesh file's dim is known once read
        why = solver_rejected(_solver_config(cfg, dim))
        if why is not None:
            raise ValueError(why)
    if launch.current_group() is not False:
        return None
    n = int(np.prod(grid))
    if n == 1:
        with launch.in_process_group(cfg.device):
            return run(cfg)
    return launch.spawn_run(cfg, n, cfg.device)


def run(cfg: RunConfig) -> RunResult:
    grid = launch.shard_grid_of(cfg)
    if grid is not None:
        res = _sharded_entry(cfg, grid)
        if res is not None:
            return res
    su = _setup(cfg)
    device, dtype, f64 = su["device"], su["dtype"], torch.float64
    disc, mesh, dt = su["disc"], su["mesh"], su["dt"]
    x0_nodes, v_nodes = su["x0"], su["v"]
    scfg = _solver_config(cfg, mesh.dim)
    exec_mode = scfg.exec_mode
    # remap runs in pseudo-time [0, 1] (remhos.cpp:1128-1134)
    t_final = 1.0 if exec_mode == 1 else cfg.t_final

    # --- initial condition (from the working-dtype nodes, in f64) ---
    u0, x_unodes = project_bernstein(
        x0_nodes.to(f64), disc.Bm_at_unodes,
        lambda x: prob.u0_function(cfg.problem, x, mesh.bb_min, mesh.bb_max))
    u0_min, u0_max = float(u0.min()), float(u0.max())
    fields = [u0]
    if cfg.product_sync:
        active_el, _ = syncm.bool_indicators(u0)
        s0 = torch.where(active_el[:, None], prob.s0_function(x_unodes), 0.0)
        fields.append(u0 * s0)
    S = torch.stack(fields).to(dtype)

    # --- the operator: of the whole mesh, or of this rank's block ---
    if grid is None:
        adv = Advection(disc, scfg, x0_nodes, v_nodes, dtype=dtype,
                        device=device, inflow=su["inflow"])
        red = _Local()
    else:
        from .parallel.sharded import make_sharded_step, shard_arrays
        comm, sharded_step, perm = make_sharded_step(
            mesh, scfg, cfg.order, grid, cfg.ode_solver,
            group=launch.current_group(), dcn=cfg.dcn, dtype=dtype,
            device=device)
        E_real = S.shape[1]
        S, x0_loc, v_loc, infl_loc = shard_arrays(
            comm, S, x0_nodes, v_nodes, su["inflow"], perm=perm,
            n_real=E_real)
        adv = sharded_step.bind(x0_loc, v_loc, infl_loc)
        red = _Shards(comm, perm, E_real)
    if cfg.verbose and red.root:
        _echo_options(cfg)

    # --- initial masses (remhos.cpp:1072-1081) ---
    # The reporting sums run in f64 whatever the working precision (the
    # reference's masses are f64): in f32 this measures the TRAJECTORY's
    # conservation, not the round-off of the reporting reduction.
    masses = adv.lumped_mass(0.0)

    def _mass(ml, field, comp=None):
        s = field.to(f64) if comp is None else field.to(f64) + comp.to(f64)
        return red.sum((ml.to(f64) * s).sum())

    mass0_u = _mass(masses, S[0])
    mass0_us = _mass(masses, S[1]) if cfg.product_sync else 0.0

    # --- stepper ---
    # `compensated`: the Kahan combine carries C; `use_closure`: the mass
    # closure also pins <ml(t), u + c> every step
    use_closure = compensated = False
    closure = None
    if grid is not None:
        # the sharded step: its aux reduced over the ranks; no closure (as
        # the JAX package runs it, remhos_tpu/driver.py:226); in f32 with
        # standard RK the Kahan combine, as the bench's sharded loop runs it
        # (the JAX driver's plain f32 combine drifts ~3e-8 of the mass a
        # step)
        compensated = dtype == torch.float32 and cfg.ode_solver <= 10
        step = sharded_step.stepper(compensated)
    elif cfg.ode_solver <= 10:
        # f32 production numerics: Kahan-compensated RK combine + per-step
        # conservative mass closure. The closure is only valid where the
        # SCHEME conserves <ml(t), u> to round-off: remap with RK3/4/6
        # (the GCL's temporal error is O(dt^4) per step; forward Euler and
        # RK2 drift at O(dt^2) and O(dt^3)), or transport on an
        # all-periodic mesh (no boundary flux, ml constant); non-periodic
        # transport has a physical in- and outflow. Never with the
        # NonlinearPenalty FCT, which is not conservative by construction
        # (remhos_fct.hpp:176).
        conservative = cfg.fct != 3 and (
            (exec_mode == 1 and cfg.ode_solver in (3, 4, 6))
            or (exec_mode == 0 and getattr(mesh, "structured", True)
                and all(mesh.periodic)))
        use_closure = compensated = (dtype == torch.float32 and cfg.closure
                                     and conservative)
        step = steppers.make_rk_step(adv.stage_function(), cfg.ode_solver,
                                     compensated=use_closure)
        if use_closure:
            v_ml = (v_nodes if v_nodes is not None
                    else torch.zeros_like(x0_nodes))
            mlk, sig = geo.lumped_mass_poly(x0_nodes, v_ml, disc)
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
    if cfg.resume and cfg.checkpoint_path:
        S_ck, t, dt, ti = ckpt.load_state(cfg.checkpoint_path)
        S = torch.as_tensor(S_ck).to(device=device, dtype=dtype)
        if grid is not None:
            # checkpoints hold S in GLOBAL element order: any shard grid
            # resumes any checkpoint
            S = shard_arrays(comm, S, x0_nodes, None, None, perm=perm,
                             n_real=E_real)[0]
        ti_total = ti
        if cfg.verbose and red.root:
            print(f"Resumed from {cfg.checkpoint_path} at step {ti}, t={t:g}")

    def x_at(t):
        """The mesh nodes at (pseudo-)time t."""
        return x0_nodes + t * v_nodes if exec_mode == 1 else x0_nodes

    def output(t, ti, visit):
        """The VisIt snapshot and the GLVis frames of step ti
        (remhos.cpp:1036-1070, 1307-1328), in global element order, from
        rank 0."""
        Sg = red.gather(S)
        if not red.root:
            return
        if visit:
            vism.visit_save(cfg.visit_prefix, mesh, x_at(t), Sg[0],
                            cfg.order, t, ti)
        if cfg.vis:
            vism.stream_fields(cfg, mesh, x_at(t), Sg[0],
                               Sg[1] if cfg.product_sync else None)

    # the initial frames, and the initial collection of a fresh run
    output(t, ti, cfg.visit and ti == 0)
    steady = cfg.problem in (6, 7, 8)
    res_prev = S[0]
    residual = 0.0
    check_global = (cfg.verify_bounds and cfg.problem % 10 not in (6, 7)
                    and (cfg.lo != 0 or cfg.mono != 0))
    if check_global:
        u_max_glob, u_min_glob = red.max_min(S[0])
    fetch_aux = cfg.verify_bounds or cfg.dt_control != 0
    C = torch.zeros_like(S) if compensated else None
    inj_acc = torch.zeros((), dtype=f64, device=device)
    synchronize(device)
    # -prof: the loop under torch.profiler (the reference's Caliper loop
    # annotation, remhos.cpp:1143-1150)
    prof = (trc.loop_profiler(device) if cfg.profile_dir and red.root
            else None)
    wall0 = time.perf_counter()
    while not done:
        dt_real = min(dt, t_final - t)
        # aux = [dt_ratio, -violations]; a step that dt control rejects is
        # dropped, closure and injected mass with it
        S_new, C_new, t_new, inj_new, aux = advance(
            step, S, t, dt_real, C=C, closure=closure, inj=inj_acc)
        ti += 1
        ti_total += 1
        if fetch_aux:
            # the step's one fetch from the device
            ratio, neg_viol = (trc.host_wait(aux.tolist)
                               if aux is not None else (math.inf, 0.0))
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
                if cfg.verbose and red.root:
                    print(f"Repeat / decrease dt: {dt_real} --> {0.85 * dt}")
                ti -= 1
                dt = 0.85 * dt
                if dt < 1e-12:
                    raise RuntimeError("The time step crashed!")
                continue
            elif ratio > 1.25:
                dt *= 1.02
        S, C, t, inj_acc = S_new, C_new, t_new, inj_new

        if not steady:
            done = t >= t_final - 1e-8 * dt
        else:
            # the reference divides by the current (post-dt-control) dt,
            # remhos.cpp:1287, not by the t_final-clamped dt_real
            diff = (masses * S[0] - masses * res_prev) / dt
            residual = math.sqrt(trc.host_wait(red.sum,
                                               (diff * diff).sum()))
            if residual < 1e-12 and t >= 1.0:
                done = True
                S = S.clone()
                S[0] = res_prev
            else:
                res_prev = S[0]
        if check_global:
            # global monotonicity assertions (remhos.cpp:1219-1260)
            u_max_new, u_min_new = trc.host_wait(red.max_min, S[0])
            if u_max_new > u_max_glob + 1e-10 or \
                    u_min_new < u_min_glob - 1e-10:
                raise RuntimeError(
                    f"Bounds violation at step {ti}: "
                    f"[{u_min_glob}, {u_max_glob}] -> "
                    f"[{u_min_new}, {u_max_new}]")
            u_max_glob, u_min_glob = u_max_new, u_min_new
        if cfg.checkpoint_steps and cfg.checkpoint_path and \
                ti % cfg.checkpoint_steps == 0:
            # the compensation is folded in: it is below the state's ulp;
            # a sharded run saves in global element order, from rank 0
            S_ck = red.gather(S + C if compensated else S)
            if red.root:
                ckpt.save_state(cfg.checkpoint_path, S_ck, t, dt, ti)
        if ti_total == cfg.max_tsteps:
            done = True
        if cfg.verbose and red.root and (done or ti % cfg.vis_steps == 0):
            print(f"time step: {ti}, time: {t:.6g}, dt: {dt:.6g}, "
                  f"residual: {residual:.6g}")
        if (cfg.visit or cfg.vis) and (done or ti % cfg.vis_steps == 0):
            output(t, ti, cfg.visit)
    synchronize(device)
    wall = time.perf_counter() - wall0
    trace_path = ""
    if prof is not None:
        trace_path = trc.write_loop_trace(prof, cfg.profile_dir, device)
        if cfg.verbose:
            print(f"Profiler trace written to {cfg.profile_dir}")

    # --- final mass / max (remhos.cpp:1382-1436) ---
    ml_final = adv.lumped_mass(t) if exec_mode == 1 else masses
    mass_u = _mass(ml_final, S[0], C[0] if compensated else None)
    max_u, min_u = red.max_min(S[0])
    res = RunResult(final_mass_u=mass_u, max_u=max_u,
                    mass_loss_u=abs(mass0_u - mass_u),
                    min_u=min_u,
                    u0_min=u0_min, u0_max=u0_max,
                    steps=ti, steps_total=ti_total, t=t, dt=dt,
                    residual=residual,
                    mass_closure_injected_rel=(
                        float(inj_acc) / max(abs(mass0_u), 1e-300)
                        if use_closure else 0.0),
                    timers={"wall_s": wall}, trace_path=trace_path)
    res.cg_solves = adv.cg_stats["solves"]
    res.cg_iterations = adv.cg_stats["iterations"]
    if grid is not None:
        res.shards = red.comm.size
        res.halo_staged_bytes = red.staged_bytes
    if adv.cfg.mono != 0:
        res.mono_stats = dict(adv.mono_stats)
    if cfg.product_sync:
        mass_us = _mass(ml_final, S[1], C[1] if compensated else None)
        s, _, _ = syncm.compute_ratio(S[1], S[0])
        res.final_mass_us = mass_us
        res.mass_loss_us = abs(mass0_us - mass_us)
        res.max_s = red.max(s)

    # --- errors of the convergence problems (remhos.cpp:1438-1470) ---
    if cfg.problem in (4, 7):
        x = adv.x0_nodes if exec_mode == 0 else (adv.x0_nodes
                                                 + t * adv.v_nodes)
        parts = l1_error_parts(adv, red.live(S[0]), cfg.problem, red.live(x))
        if grid is not None:
            parts = torch.cat([red.comm.all_sum(parts[:2]),
                               red.comm.all_max(parts[2:])])
        p = parts.tolist()
        errs = p[0], math.sqrt(p[1]), p[2]
        res.l1_error = errs[0]
        if cfg.problem == 7 and cfg.verbose and red.root:
            # the reference appends L1, L2 and Linf (remhos.cpp:1452-1469)
            with open("errors.txt", "a") as fh:
                fh.write("%.12g %.12g %.12g\n" % errs)

    Sg = red.gather(S) if cfg.save and grid is not None else S
    if cfg.save and red.root:
        # the reference's artifacts (remhos.cpp:1365-1380): an MFEM mesh and
        # grid function, loadable by GLVis and by `umesh.load_general_mesh`
        S = Sg
        x_final = x_at(t)
        np.savez("sltn_final.npz", u=S[0].cpu().numpy(),
                 x=x_final.cpu().numpy(), t=t,
                 shape=np.asarray(mesh.shape
                                  if getattr(mesh, "structured", True)
                                  else (mesh.num_elements,)))
        vism.save_final(mesh, x_final, S[0], cfg.order)
        if cfg.verbose:
            print("Saved final solution to meshHO_final.mesh / "
                  "sltn_final.gf (+ sltn_final.npz)")

    if cfg.verbose and red.root:
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
        if res.l1_error >= 0:
            print(f"L1-error: {res.l1_error:.6g}.")
    return res
