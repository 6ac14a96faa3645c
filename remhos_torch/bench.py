"""The verified remap benchmark case on the GPU: the port of the main-path
parts of bench.py.

The case is bench.py's: a 3D Cartesian N^3 mesh, order p=3, remap problem
10, `-ho 3 -lo 5 -fct 2 -pa`, RK3-SSP with the Kahan-compensated combine,
the state in f32 pinned by the incremental mass closure every step and one
full f64 closure at the end. A run is verified before any number is
reported, with bench.py's budgets and tolerances unchanged:

- `verify`: mass conservation of the closed state, the closure's injected
  mass against its drift budget, and no overshoot or undershoot;
- `cross_precision_check`: the f32 state after 2 steps against 2 f64 steps,
  which catches a silently degenerate f32 hot path.

A check that did not run is reported as skipped, never as passed.

The figure of merit keeps the reference's stage counting (remhos.cpp:
1340-1347): MDOF * RK-stages / s.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from . import problems as prob
from . import resolve_device
from . import steppers as st
from .discretization import build_discretization
from .driver import _integrate_mesh_velocity, _project_bernstein
from .geometry import lumped_mass_poly
from .mesh import make_cartesian_mesh
from .operator import Advection, SolverConfig

STAGES = 3          # RK3: the FOM counts stages (remhos.cpp:1340-1347)
PROBLEM = 10


@dataclasses.dataclass
class Case:
    disc: object
    adv: Advection            # working-precision operator
    adv64: Advection          # f64 verification operator
    step: object
    u0: torch.Tensor          # initial state in the working dtype
    u0_64: torch.Tensor       # the same before the cast (cross check)
    dt: float
    n_steps: int
    closure: object = None
    closure_inc: object = None
    sig: np.ndarray = None
    mlk32: torch.Tensor = None

    @property
    def ndofs(self) -> int:
        return self.u0.numel()


def build_case(n=24, order=3, dtype=torch.float32, device=None,
               n_steps=320, dt=None, dim=3) -> Case:
    """bench.build_case (bench.py:128-208) on `device` (None -> CUDA).

    dtype float32: the production case, with the mass closures. float64:
    the reference-precision case, with neither (as bench.py runs it)."""
    device = resolve_device(device)
    mesh = make_cartesian_mesh(dim, (n,) * dim, (0.0,) * dim, (1.0,) * dim,
                               (False,) * dim)
    disc = build_discretization(mesh, order)
    cfg = SolverConfig(problem=PROBLEM, ho=3, lo=5, fct=2, ode_solver=3,
                       pa=True)
    dt = 0.2 / n_steps if dt is None else float(dt)
    f64 = torch.float64
    x0 = torch.as_tensor(mesh.x, dtype=f64, device=device)
    v = _integrate_mesh_velocity(x0, PROBLEM, mesh.bb_min, mesh.bb_max,
                                 0.7, dt)
    u0, _ = _project_bernstein(
        x0, disc.Bm_at_unodes,
        lambda x: prob.u0_function(PROBLEM, x, mesh.bb_min, mesh.bb_max))
    adv64 = Advection(disc, cfg, x0, v, dtype=f64, device=device)
    case = Case(disc=disc, adv=adv64, adv64=adv64, step=None, u0=u0,
                u0_64=u0, dt=dt, n_steps=n_steps)
    if dtype == torch.float32:
        # conservative mass closure, pinned to the mass of the f32-cast
        # initial state in the f32-mlk metric so the loop starts closed
        mlk, sig = lumped_mass_poly(x0, v, disc)
        case.mlk32 = mlk.to(dtype)
        case.sig = sig.cpu().numpy()
        case.u0 = u0.to(dtype)
        m0 = float(case.mlk32[0].double().reshape(-1)
                   @ case.u0.double().reshape(-1))
        case.closure = st.make_mass_closure(case.mlk32, case.sig, m0)
        case.closure_inc = st.make_mass_closure_inc(case.mlk32)
        case.adv = Advection(disc, cfg, x0.to(dtype), v.to(dtype),
                             dtype=dtype, device=device)
    elif dtype != f64:
        raise TypeError(f"build_case takes float32 or float64, not {dtype}")
    case.step = st.make_rk_step(case.adv.stage_function(), 3,
                                compensated=True,
                                with_delta=case.closure_inc is not None)
    return case


def _as_dtype(t, dtype):
    """A float rounded to `dtype`, as the stage sees the f64-carried t."""
    return float(torch.tensor(t, dtype=torch.float64).to(dtype))


def run_steps(case: Case, n_steps=None):
    """The step loop (bench.py:211-265) as a Python loop.

    t is carried in f64 and each stage sees it rounded to the working dtype
    once. With the closures: the incremental closure each step (its f64
    scalars precomputed on the host), then one full closure. The steppers
    and the operator work on the block state S[nfields, E, nd]; this case
    has one field, and u, c go in and come out as [E, nd]. Returns
    (u, c, injected, t), injected the f64 sum of |mass| the closures
    absorbed (0.0 without closure)."""
    n_steps = case.n_steps if n_steps is None else n_steps
    dt, step = case.dt, case.step
    u = case.u0[None].clone()          # the block state S[1, E, nd]
    c = torch.zeros_like(u)
    acc = torch.zeros((), dtype=torch.float64, device=u.device)
    t = 0.0
    if case.closure_inc is not None:
        coefs = [torch.as_tensor(a, dtype=torch.float64, device=u.device)
                 for a in st.closure_coefs(case.sig, dt, n_steps)]
    for i in range(n_steps):
        t_new = t + dt
        if case.closure_inc is not None:
            u, c, _, delta = step(u, c, _as_dtype(t, u.dtype), dt)
            c0, deficit = case.closure_inc(u[0], c[0], delta[0],
                                           tuple(a[i] for a in coefs))
            c = c0[None]
            acc = acc + deficit.abs()
        else:
            u, c, _ = step(u, c, _as_dtype(t, u.dtype), dt)
        t = t_new
    u, c = u[0], c[0]
    if case.closure is not None:
        c, deficit = case.closure(u, c, t)
        acc = acc + deficit.abs()
    return u, c, float(acc), t


def verify(adv64, u0, uT, dt, n_steps, cT=None, injected=None,
           metric32=None):
    """bench.verify (bench.py:268-371): invariant checks on the final state
    with the f64 operator; raises AssertionError on failure. Returns
    (mass_rel_loss, injected_rel or None)."""
    f64 = torch.float64
    ml0 = adv64.lumped_mass(0.0)
    mlT = adv64.lumped_mass(n_steps * dt)
    uTe = uT.to(f64) + (cT.to(f64) if cT is not None else 0.0)
    mass0 = float((ml0 * u0.to(f64)).sum())
    massT = float((mlT * uTe).sum())
    rel_loss = abs(massT - mass0) / abs(mass0)
    is32 = u0.dtype == torch.float32
    # RK3 meets the moving-mesh GCL only to O(dt^4) per step; f32 adds a
    # random walk and a systematic stage-rounding term (bench.py:314-338)
    gcl = n_steps * max(5e-7 * (dt / 0.02) ** 4, 3e-11)
    sys_rate = 8e-9 * max(1.0, dt / 6.25e-4)
    drift_budget = gcl + (1e-7 * n_steps ** 0.5 + sys_rate * n_steps
                          if is32 else 2e-8 + 3e-12 * n_steps)
    inj_rel = None
    if injected is not None:
        inj_rel = injected / abs(mass0)
        if not inj_rel < drift_budget:
            raise AssertionError(f"mass closure absorbed too much: "
                                 f"{inj_rel:g} (conservation bug?)")
        tol = 2e-9 + 3e-12 * n_steps
        if metric32 is not None:
            # the closure pins <ml32(t), u+c>; this check measures
            # <ml64(t), u+c>: the metric-mismatch functional, computed
            # here, is the tolerance (bench.py:348-364)
            T = n_steps * dt
            m64 = metric32.to(f64)
            K = m64.shape[0]
            mlT_p = sum(T ** k * m64[k] for k in range(K))
            t0 = ((ml0 - m64[0]) * u0.to(f64)).sum()
            tT = ((mlT - mlT_p) * uTe).sum()
            tol = abs(float(tT - t0)) / abs(mass0) + 2e-10 + 3e-12 * n_steps
    else:
        tol = drift_budget
    if not rel_loss < tol:
        raise AssertionError(f"mass conservation broken: rel loss "
                             f"{rel_loss:g} (tolerance {tol:g})")
    btol = 1e-5 if is32 else 1e-10
    if not float(uT.max()) <= float(u0.max()) + btol:
        raise AssertionError("overshoot")
    if not float(uT.min()) >= float(u0.min()) - btol:
        raise AssertionError("undershoot")
    return rel_loss, inj_rel


def cross_precision_check(u2, dt, adv64, u0_64):
    """bench.cross_precision_check (bench.py:380-405): the f32 state after
    2 steps against 2 plain RK3 steps of the f64 operator from the f64
    initial state. The f32 input floor is ~7e-4 per HO solve; the failure
    modes this guards against sit at 0.3 (bf16 products) and O(1)
    (a degenerate mass solve). Returns the relative 2-norm difference."""
    step64 = st.make_rk_step(adv64.stage_function(), 3)
    u, t = u0_64[None], 0.0
    for _ in range(2):
        u, _ = step64(u, t, dt)
        t = t + dt
    ref = u[0].double()
    rel = float(torch.linalg.norm(u2.double() - ref) / torch.linalg.norm(ref))
    if not rel < 1e-2:
        raise AssertionError(
            f"f32 state diverges from f64 after 2 steps: {rel:g}")
    return rel


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(case: Case) -> dict:
    """Time the step loop, then verify it. One record, verified or raised.

    The wall time is one pass of the loop, not bench.py's best of
    BENCH_REPS passes of a compiled loop (bench.py:512-517). The cross check
    runs only for a float32 case (it holds f32 against f64); a float64 case
    records it as skipped."""
    dev = case.u0.device
    _sync(dev)
    t0 = time.perf_counter()
    uT, cT, injected, _ = run_steps(case)
    _sync(dev)
    wall = time.perf_counter() - t0
    closed = case.closure is not None
    rel_loss, inj_rel = verify(case.adv64, case.u0, uT, case.dt,
                               case.n_steps, cT=cT,
                               injected=injected if closed else None,
                               metric32=case.mlk32)
    if case.u0.dtype == torch.float32:
        u2, _, _, _ = run_steps(case, 2)
        cross = {"status": "ran",
                 "f32_vs_f64_2step_rel": cross_precision_check(
                     u2, case.dt, case.adv64, case.u0_64)}
    else:
        cross = {"status": "skipped", "reason": "float64 case"}
    stage_calls = case.n_steps * STAGES
    return {
        "metric": "fom_total_p%d_%dd_remap_pa_%s" % (
            case.disc.p, case.disc.dim,
            "f32" if case.u0.dtype == torch.float32 else "f64"),
        "ndofs": case.ndofs,
        "steps": case.n_steps,
        "wall_s": wall,
        "ms_per_stage": 1e3 * wall / stage_calls,
        "MDOF_stages_per_s": 1e-6 * case.ndofs * stage_calls / wall,
        "mass_rel_loss": rel_loss,
        "mass_closure_injected_rel": inj_rel,
        "cross_check": cross,
        "verified": True,
    }
