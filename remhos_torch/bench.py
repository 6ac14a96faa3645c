"""The verified remap benchmark on the GPU: the port of bench.py.

The case is bench.py's: a 3D Cartesian N^3 mesh, order p, remap problem 10,
`-ho 3 -lo 5 -fct 2 -pa`, RK3-SSP with the Kahan-compensated combine; in
f32 the state is pinned by the mass closure (BENCH_CLOSURE: "1" the
incremental closure every step and one full f64 closure at the end, "full"
the full closure every step, "0" none); in f64 it runs without closures. A
run is verified before any number is reported, with bench.py's budgets and
tolerances unchanged:

- `verify`: mass conservation of the closed state, the closure's injected
  mass against its drift budget, and no overshoot or undershoot;
- `cross_precision_check`: the f32 state after 2 steps against 2 f64 steps,
  which catches a silently degenerate f32 hot path.

A check that did not run is recorded as skipped and leaves `verified` not
true.

The figure of merit keeps the reference's stage counting (remhos.cpp:
1340-1347): MDOF * RK-stages / s, over the best of BENCH_REPS windows after
one warm-up window. Each window is one pass of the step loop with a
`torch.cuda.synchronize` on either side. The loop is a Python loop that the
host drives, one launch at a time: bench.py's argument for its window (one
`lax.scan` dispatch amortizes a fixed latency) does not carry over, and the
window's wall includes the host's work.

    python -m remhos_torch.bench          (`main`: one leg, verified)

Knobs, read by `knobs()` with bench.py's names and defaults: BENCH_N (24),
BENCH_P (3), BENCH_STEPS (320), BENCH_DT (0.2/steps), BENCH_REPS (4),
BENCH_CROSSCHECK, BENCH_VERIFY, BENCH_DTYPE (float32), BENCH_CLOSURE
(1|full|0), BENCH_PHASES, BENCH_TRACE, BENCH_CROSSDUMP, BENCH_POLY_BF16 (0:
1 streams va and vn in bf16, f32 only; the closure's injection budget and
the cross check are its gates) and BENCH_SHARDED (0: n runs the same
production loop sharded over a process group of n, `sharded_record`). The
TPU's BENCH_PALLAS=0 (the plain version on the device, which the port does
not offer on the card) raises ValueError. Nothing here writes os.environ;
`python -m remhos_torch.tools.sweep` runs one process a (N, p) point.

The sharded loop (bench.py:441-490) is the production loop in a process
group: each rank runs its block through `parallel.sharded`'s step with the
Kahan-compensated combine and no closure, so it is verified against the
open-mode drift budget. One shard runs in this process (NCCL on the card,
gloo on the CPU), more in spawned ranks (`parallel.launch.spawn`), with
rank 0's record returned.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from . import ops
from . import problems as prob
from . import resolve_device, synchronize
from . import steppers as st
from .discretization import build_discretization
from .driver import integrate_mesh_velocity, project_bernstein
from .geometry import lumped_mass_poly
from .mesh import make_cartesian_mesh
from .operator import Advection, SolverConfig
from .utils import cost
from .utils.trace import host_wait

STAGES = 3          # RK3: the FOM counts stages (remhos.cpp:1340-1347)
PROBLEM = 10
# the reference's dev-machine run on the stage-counting basis
# (remhos_tests.cpp:53-58: 2.56M dofs, 5 steps, RK3, 5.537 s):
# 2.56 * 5 * 3 / 5.537 = 6.935 MDOF*stages/s. Not a TPU or GPU number.
BASELINE_FOM = 6.935


def _env_on(env, name, default="1"):
    return env.get(name, default) not in ("0", "false", "")


def knobs(env=None) -> dict:
    """The BENCH_* knobs of `env` (os.environ) with bench.py's defaults.
    Raises ValueError for the TPU-only knobs."""
    env = os.environ if env is None else env
    if not _env_on(env, "BENCH_PALLAS"):
        raise ValueError(
            "BENCH_PALLAS=0 asks for the plain version on the device; the "
            "port runs its kernels on the card (the plain versions are the "
            "CPU's and the tests' references), ROADMAP.md Queue 2")
    steps = int(env.get("BENCH_STEPS", "320"))
    closure = env.get("BENCH_CLOSURE", "1")
    if closure not in ("1", "full", "0"):
        raise ValueError(f"BENCH_CLOSURE={closure!r}: 1, full or 0")
    dtype = env.get("BENCH_DTYPE", "float32")
    if dtype not in ("float32", "float64"):
        raise ValueError(f"BENCH_DTYPE={dtype!r}: float32 or float64")
    return dict(
        n=int(env.get("BENCH_N", "24")), p=int(env.get("BENCH_P", "3")),
        steps=steps, dt=float(env.get("BENCH_DT") or 0.2 / steps),
        reps=max(1, int(env.get("BENCH_REPS", "4"))),
        dtype=dtype, closure=closure,
        crosscheck=_env_on(env, "BENCH_CROSSCHECK"),
        verify=_env_on(env, "BENCH_VERIFY"),
        phases=_env_on(env, "BENCH_PHASES"),
        trace=_env_on(env, "BENCH_TRACE"),
        crossdump=env.get("BENCH_CROSSDUMP", ""),
        poly_bf16=_env_on(env, "BENCH_POLY_BF16", "0"),
        sharded=int(env.get("BENCH_SHARDED", "0")))


def device_line(device) -> str:
    """The card's name and power limit as `nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader` gives them; "cpu" on the CPU."""
    device = torch.device(device)
    if device.type != "cuda":
        return "cpu"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    lines = out.stdout.strip().splitlines()
    return lines[min(device.index or 0, len(lines) - 1)]


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
    u_final: torch.Tensor = None   # the state after the last timed window

    @property
    def ndofs(self) -> int:
        return self.u0.numel()


def build_case(n=24, order=3, dtype=torch.float32, device=None,
               n_steps=320, dt=None, dim=3, closure="1",
               poly_bf16=False) -> Case:
    """bench.build_case (bench.py:128-208) on `device` (None -> CUDA).

    dtype float32: the production case, with the mass closure of
    `closure` ("1": incremental every step and one full at the end; "full":
    the full closure every step; "0": none). float64: the
    reference-precision case, with neither (as bench.py runs it).
    poly_bf16: the working operator streams va and vn in bf16 (f32 only;
    the f64 verification operator never does)."""
    device = resolve_device(device)
    mesh = make_cartesian_mesh(dim, (n,) * dim, (0.0,) * dim, (1.0,) * dim,
                               (False,) * dim)
    disc = build_discretization(mesh, order)
    cfg = SolverConfig(problem=PROBLEM, ho=3, lo=5, fct=2, ode_solver=3,
                       pa=True)
    dt = 0.2 / n_steps if dt is None else float(dt)
    f64 = torch.float64
    x0 = torch.as_tensor(mesh.x, dtype=f64, device=device)
    v = integrate_mesh_velocity(x0, PROBLEM, mesh.bb_min, mesh.bb_max,
                                0.7, dt)
    u0, _ = project_bernstein(
        x0, disc.Bm_at_unodes,
        lambda x: prob.u0_function(PROBLEM, x, mesh.bb_min, mesh.bb_max))
    adv64 = Advection(disc, cfg, x0, v, dtype=f64, device=device)
    case = Case(disc=disc, adv=adv64, adv64=adv64, step=None, u0=u0,
                u0_64=u0, dt=dt, n_steps=n_steps)
    if dtype == torch.float32:
        case.u0 = u0.to(dtype)
        if closure != "0":
            # conservative mass closure, pinned to the mass of the f32-cast
            # initial state in the f32-mlk metric so the loop starts closed
            mlk, sig = lumped_mass_poly(x0, v, disc)
            case.mlk32 = mlk.to(dtype)
            case.sig = sig.cpu().numpy()
            m0 = float(case.mlk32[0].double().reshape(-1)
                       @ case.u0.double().reshape(-1))
            case.closure = st.make_mass_closure(case.mlk32, case.sig, m0)
            if closure == "1":
                case.closure_inc = st.make_mass_closure_inc(case.mlk32)
        case.adv = Advection(
            disc, dataclasses.replace(cfg, poly_bf16=poly_bf16),
            x0.to(dtype), v.to(dtype), dtype=dtype, device=device)
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
    once. With the incremental closure: it every step (its f64 scalars
    precomputed on the host), then one full closure; with the full closure
    alone: it every step. The steppers and the operator work on the block
    state S[nfields, E, nd]; this case has one field, and u, c go in and
    come out as [E, nd]. Returns (u, c, injected, t), injected the f64 sum
    of |mass| the closures absorbed (0.0 without closure)."""
    n_steps = case.n_steps if n_steps is None else n_steps
    dt, step = case.dt, case.step
    u = case.u0[None].clone()          # the block state S[1, E, nd]
    c = torch.zeros_like(u)
    acc = torch.zeros((), dtype=torch.float64, device=u.device)
    t = 0.0
    if case.closure_inc is not None:
        # blocking host-to-device copies: each waits for the stream
        coefs = [host_wait(torch.as_tensor, a, dtype=torch.float64,
                           device=u.device)
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
            if case.closure is not None:
                c0, deficit = case.closure(u[0], c[0], t_new)
                c = c0[None]
                acc = acc + deficit.abs()
        t = t_new
    u, c = u[0], c[0]
    if case.closure_inc is not None:
        # the exact f64 re-anchor, once a run
        c, deficit = case.closure(u, c, t)
        acc = acc + deficit.abs()
    return u, c, host_wait(float, acc), t


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


def stage_bytes_model(case: Case):
    """bench.py's analytic bytes per RK stage of the fused main path
    (bench.py:408-438) from the port's operand sizes: the mega kernel's
    least bytes (`utils.cost.stage_cost`), the gather (reads u, writes
    u_nbr), the bounds (reads u, writes the two class stencils), the RK
    combine (4 nd) and, with a closure, its per-step reads of mlk, u and c
    and write of c over the 3 stages. None off the mega path."""
    adv = case.adv
    if not adv._mega_stage_eligible():
        return None
    from .ops.stage_core import default_sweeps
    tb = adv._stage_tables
    kernel, _ = cost.stage_cost(tb, adv._poly, default_sweeps(adv.dtype))
    E, nd, dim = case.u0.shape[0], tb["nd"], tb["dim"]
    nbr, bcols = tb["nf"] * tb["fd"], 3 ** dim
    cols = (nd + nbr) + (nd + 2 * bcols) + 4 * nd
    if case.closure is not None:
        cols += ((dim + 1) * nd + 3 * nd) / 3.0
    return int(kernel + case.u0.element_size() * E * cols)


def run(case: Case, reps=1, warmup=False, verify_state=True,
        crosscheck=True, phases=False, trace=False, measure_steps=40) -> dict:
    """Time the step loop, then verify it: one record.

    warmup runs one untimed window first; the wall time is the best of
    `reps` windows (bench.py:510-517), each synchronized on both sides.
    `kernels` counts each hand kernel's launches over the timed windows.
    verify_state: `verify`, which raises on failure. crosscheck (float32
    only): the 2-step f32-vs-f64 check. A check that does not run is
    recorded as skipped and leaves `verified` false; in float64 the cross
    check does not apply (it holds f32 against f64).

    trace=True (bench.py's BENCH_TRACE) adds, from a torch.profiler trace
    of min(n_steps, measure_steps) steps of the same loop: kernel and glue
    microseconds per stage, the top five glue ops, the device's idle share
    over the traced window and against the wall of an untraced pass of the
    same steps, and the trace's kernel events and the launch counters over
    it, and from the program's spans the device and idle microseconds a
    stage by the innermost span, the host's own microseconds a stage and
    the host waits a step. phases=True (bench.py's BENCH_PHASES) adds the
    phase ablation's FOMs (utils/fom.py) over min(n_steps, measure_steps)
    steps and prints the reference's report. The state after the last
    window is left in `case.u_final`."""
    dev = case.u0.device
    if warmup:
        run_steps(case)
    before = ops.launch_counts()
    wall = float("inf")
    for _ in range(max(1, reps)):
        synchronize(dev)
        t0 = time.perf_counter()
        uT, cT, injected, _ = run_steps(case)
        synchronize(dev)
        wall = min(wall, time.perf_counter() - t0)
    launches = {k: n - before[k] for k, n in ops.launch_counts().items()}
    case.u_final = uT
    is32 = case.u0.dtype == torch.float32
    ok = True
    rel_loss = inj_rel = None
    if verify_state:
        rel_loss, inj_rel = verify(
            case.adv64, case.u0, uT, case.dt, case.n_steps, cT=cT,
            injected=injected if case.closure is not None else None,
            metric32=case.mlk32)
    else:
        ok = False
    rel2 = None
    if not is32:
        cross = {"status": "skipped", "reason": "float64 case"}
    elif crosscheck:
        u2, _, _, _ = run_steps(case, 2)
        rel2 = cross_precision_check(u2, case.dt, case.adv64, case.u0_64)
        cross = {"status": "ran", "f32_vs_f64_2step_rel": rel2}
    else:
        cross = {"status": "skipped", "reason": "BENCH_CROSSCHECK=0"}
        ok = False
    stage_calls = case.n_steps * STAGES
    fom = 1e-6 * case.ndofs * stage_calls / wall
    on_card = dev.type == "cuda"
    bmodel = stage_bytes_model(case)
    gbs = (bmodel * stage_calls / wall / 1e9
           if bmodel is not None and on_card else None)
    result = {
        "metric": "fom_total_p%d_%dd_remap_pa_%s" % (
            case.disc.p, case.disc.dim, "f32" if is32 else "f64"),
        "ndofs": case.ndofs,
        "value": fom,
        "unit": "MDOF*stages/s",
        "vs_baseline": fom / BASELINE_FOM,
        "verified": ok,
        "mass_rel_loss": rel_loss,
        "mass_closure_injected_rel": inj_rel,
        "f32_vs_f64_2step_rel": rel2,
        "cross_check": cross,
        "steps": case.n_steps,
        "windows": max(1, reps),
        "wall_s": wall,
        "ms_per_stage": 1e3 * wall / stage_calls,
        # the least bytes a stage moves, and those bytes over the window's
        # wall against the H100's 3.35 TB/s (none on the CPU)
        "hbm_bytes_per_stage_model": bmodel,
        "hbm_gb_per_s_model": gbs,
        "hbm_util_model": (gbs * 1e9 / cost.PEAK_BYTES_PER_S
                           if gbs is not None else None),
        "kernels": launches,
        "device": device_line(dev),
    }
    m_steps = min(case.n_steps, measure_steps)
    if trace:
        result.update(_trace_record(case, m_steps))
    if phases:
        from .utils.fom import measure_phases, print_fom_report
        ph = measure_phases(case.adv, case.u0, case.dt, n_steps=m_steps,
                            device=dev)
        foms = print_fom_report(ph, case.ndofs, m_steps * STAGES,
                                total_wall=ph.get("wall_total"))
        result.update(foms)
        result["phase_s_per_stage"] = {
            k: ph[k] for k in ("combine", "rhs", "inv", "lo", "bounds", "fct",
                               "pipeline_total", "noise_floor")}
        result["phase_timing_source"] = ph["timing_source"]
    return result


def sharded_record(case: Case, n_shards: int, reps=1, verify_state=True):
    """The production loop of `case` sharded over a process group of
    n_shards ranks (bench.py:441-490, make_sharded_loop), which this
    process must be a rank of: each rank's block through
    `parallel.sharded`'s step with the Kahan-compensated combine and no
    closure, timed over `reps` windows after one warm-up, the final state
    gathered and verified against the open-mode drift budget. Every rank
    returns the record."""
    from .parallel import launch
    from .parallel.sharded import make_sharded_step, shard_arrays
    adv = case.adv
    dev = case.u0.device
    comm, sstep, perm = make_sharded_step(
        case.disc.mesh, adv.cfg, case.disc.p, (n_shards,), 3,
        group=launch.current_group(), dtype=case.u0.dtype, device=dev,
        loop=case.n_steps)
    S, x0, v, _ = shard_arrays(comm, case.u0[None], adv.x0_nodes,
                               adv.v_nodes, None, perm=perm)
    inv = torch.as_tensor(np.argsort(perm), device=dev)

    def loop():
        return sstep(S, 0.0, case.dt, x0, v, None)[0]

    loop()                                       # warm-up window
    before = ops.launch_counts()
    wall = float("inf")
    for _ in range(max(1, reps)):
        synchronize(dev)
        comm.barrier()
        t0 = time.perf_counter()
        out = loop()
        synchronize(dev)
        comm.barrier()
        wall = min(wall, time.perf_counter() - t0)
    launches = {k: n - before[k] for k, n in ops.launch_counts().items()}
    uT = comm.all_gather(out[0]).index_select(0, inv)
    rel_loss = None
    if verify_state:
        rel_loss, _ = verify(case.adv64, case.u0, uT, case.dt, case.n_steps)
    stage_calls = case.n_steps * STAGES
    fom = 1e-6 * case.ndofs * stage_calls / wall
    case.u_final = uT
    return {
        "metric": "fom_total_p%d_%dd_remap_pa_%s_sharded%d" % (
            case.disc.p, case.disc.dim,
            "f32" if case.u0.dtype == torch.float32 else "f64", n_shards),
        "ndofs": case.ndofs, "value": fom, "unit": "MDOF*stages/s",
        "vs_baseline": fom / BASELINE_FOM, "verified": bool(verify_state),
        "mass_rel_loss": rel_loss, "mass_closure_injected_rel": None,
        "steps": case.n_steps, "windows": max(1, reps), "wall_s": wall,
        "ms_per_stage": 1e3 * wall / stage_calls, "shards": n_shards,
        "halo_staged_bytes": comm.staged_bytes,
        "kernels": launches, "device": device_line(dev)}


def _sharded_leg(n, p, steps, dt, dtype, reps, verify_state, device,
                 n_shards, poly_bf16):
    """A rank's part of a sharded leg (run in each spawned rank)."""
    case = build_case(n, p, dtype, device, n_steps=steps, dt=dt,
                      closure="0", poly_bf16=poly_bf16)
    return sharded_record(case, n_shards, reps, verify_state)


def leg(n, p, steps, dt, dtype, reps, closure, verify_state, crosscheck,
        trace, phases, device, shards, poly_bf16):
    """One leg of a record: build the case at (n, p), time it and verify
    it (`run`). Returns (record, u after the last timed window). With
    `shards` > 0 the leg is the sharded loop (`sharded_record`): in this
    process for one shard, in spawned ranks for more; its final state is
    None."""
    if shards:
        from .parallel import launch
        args = (n, p, steps, dt, dtype, reps, verify_state, device, shards,
                poly_bf16)
        if launch.current_group() is not False:
            rec = _sharded_leg(*args)
        elif shards == 1:
            with launch.in_process_group(device):
                rec = _sharded_leg(*args)
        else:
            rec = launch.spawn(_sharded_leg, shards, device, *args)
        return rec, None
    case = build_case(n, p, dtype, device, n_steps=steps, dt=dt,
                      closure=closure, poly_bf16=poly_bf16)
    rec = run(case, reps=reps, warmup=True, verify_state=verify_state,
              crosscheck=crosscheck, trace=trace, phases=phases)
    if poly_bf16:
        rec["poly_bf16"] = True
    return rec, case.u_final


def main(device=None, env=None) -> dict:
    """bench.py's main (bench.py:489-634): one leg under the BENCH_* knobs
    of `env` (os.environ); prints its JSON record and returns it."""
    k = knobs(env)
    dtype = torch.float32 if k["dtype"] == "float32" else torch.float64
    rec, u_final = leg(
        k["n"], k["p"], k["steps"], dt=k["dt"], dtype=dtype, reps=k["reps"],
        closure=k["closure"], verify_state=k["verify"],
        crosscheck=k["crosscheck"], trace=k["trace"], phases=k["phases"],
        device=device, shards=k["sharded"], poly_bf16=k["poly_bf16"])
    if k["crossdump"] and u_final is not None:
        np.save(k["crossdump"], u_final.double().cpu().numpy())
    print(json.dumps(rec), flush=True)
    print(f"# {rec['ndofs']} dofs, {k['steps']} steps, {rec['wall_s']:.3f} s"
          f" on {rec['device']}", file=sys.stderr)
    return rec


def _trace_record(case, tr_steps) -> dict:
    """The trace keys of `run`: one traced pass of tr_steps steps of the
    benched loop (bench.py:582-616 without XLA's placement bytes)."""
    from .utils import trace as trc
    dev = case.u0.device
    run_steps(case, tr_steps)                    # warm
    synchronize(dev)
    t0 = time.perf_counter()
    run_steps(case, tr_steps)                    # the same pass, untraced
    synchronize(dev)
    wall = time.perf_counter() - t0
    tr, launches = trc.capture_counted(lambda: run_steps(case, tr_steps))
    rep = trc.loop_report(tr, tr_steps, STAGES)
    host = rep["host_s_per_stage"]
    return {
        "kernel_us_per_stage": rep["kernel_s_per_stage"] * 1e6,
        "glue_us_per_stage": rep["glue_s_per_stage"] * 1e6,
        "glue_breakdown_us": {
            k: v * 1e6
            for k, v in list(rep["buckets_s_per_stage"].items())[:5]},
        # the program's spans: device and idle us a stage by the innermost
        # span, the host's own us a stage, the host waits a step
        "device_us_per_stage_by_span": {
            k: v * 1e6 for k, v in rep["device_s_per_stage_by_span"].items()},
        "idle_us_per_stage_by_span": {
            k: v * 1e6 for k, v in rep["idle_s_per_stage_by_span"].items()},
        "host_us_per_stage": host * 1e6 if host is not None else None,
        "host_syncs_per_step": rep["host_syncs_per_call"],
        "idle_share": rep["idle_share"],
        # the profiler slows the host: the same device work against the
        # wall of the untraced pass
        "idle_share_untraced": 1.0 - rep["busy_s"] / wall,
        "trace_steps": tr_steps,
        "trace_kernel_events": trc.kernel_events(tr),
        "trace_launches": launches,
    }


if __name__ == "__main__":
    main()
