"""Per-phase timing and the reference's figure-of-merit report.

The counterpart of `remhos_tpu/utils/fom.py` (TimingData/PrintTimingData,
remhos_tools.hpp:52-64, remhos.cpp:1918-1966): times for the RHS (K u with
the per-stage remap geometry), INV (mass inverse), LO and FCT phases, and
the five FOMs in megadofs x time steps / second. Meaningful for the
canonical configuration -ho 3 -lo 5 -fct 2, as in the reference.

Method: COMPOSED ABLATION at step granularity. The real RK step loop is
timed with the stage function replaced by growing prefixes of the real
stage pipeline:

  L0 combine   the RK combine only (no stage work)
  L1 rhs       + geometry + K u (volume convection + DG face flux)
  L2 inv       + GL mass inverse            -> du_HO
  L3 lo        + MassBasedAvg               -> du_LO
  L4 bounds    + element min/max + overlap dof bounds
  L5 fct       the REAL stage function (ClipScale + aux channel)

Each level is the port's `steppers.make_rk_step` loop, a Python loop over
eager launches, so L5 is the benched loop and the phase deltas plus L0 add
up to its time. On the card the levels are timed by their DEVICE time from a
`torch.profiler` trace (utils/trace.py): the deltas are then the device
work of each phase, and the host's share of the loop (its wall time less
its device time) is reported as its own "dispatch" bucket. On the CPU,
where no device time exists, each level is timed by the host clock around
the synchronized loop, best of `reps`, and a
two-length fit of L0 separates the fixed per-loop cost. A noise floor
(spread of repeated L5 runs) is printed so that small phases are read as
upper bounds.
"""

from __future__ import annotations

import time

import torch

from .. import assembly as asm
from .. import bounds as bnd
from .. import lo as lom
from .. import pa as pam
from .. import resolve_device, synchronize
from .. import steppers
from ..ops.geom_conv import geom_conv
from . import trace as trc

LABELS = {0: "combine", 1: "rhs", 2: "inv", 3: "lo", 4: "bounds", 5: "fct"}
STAGES = {1: 1, 2: 2, 3: 3, 4: 4, 6: 8}    # RK kind -> stages (6: Verner)


def _indexed(device):
    """`device` with the current CUDA device's index where it has none."""
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def _loop(step, S, dt, n_steps):
    """n_steps steps of `step` from S at t = 0.1 (the JAX tool's scan body:
    every step sees the same stage time)."""
    def run():
        s = S
        for _ in range(n_steps):
            s, _ = step(s, 0.1, dt)
        synchronize(S.device)
        return s
    return run


def _timed_loop(step, S, dt, n_steps, reps=3):
    """(best, worst) host wall time of a synchronized n_steps loop over
    `step`, after one warm-up pass."""
    run = _loop(step, S, dt, n_steps)
    run()
    best, worst = float("inf"), 0.0
    for _ in range(reps):
        t0 = time.perf_counter()
        run()
        w = time.perf_counter() - t0
        best, worst = min(best, w), max(worst, w)
    return best, worst


def _make_stage_prefix(adv, dtype):
    """stage_prefix(level) -> stage function running the first `level`
    phases of the real pipeline (see the module docstring). Level 5 IS the
    real stage function."""
    aux0 = torch.tensor([float("inf"), 0.0], dtype=dtype, device=adv.device)

    def stage_prefix(level):
        if level == 5:
            return adv.stage_function()

        def f(t, dt_, Sv):
            u = Sv[0]
            if level == 0:
                # alive but trivial: the integrator alone
                return Sv * (1.0 + 1e-30 * t), aux0
            geom = adv.geometry(t)
            if adv._fused_stage:
                if level >= 3 and adv.cfg.lo == 5 and adv.cfg.fct == 2:
                    # as the real stage: the HO kernel emits the LO solution,
                    # so its cost lands in this level's delta, not in fct's
                    geom["fused_lo"] = True
                    geom["dt"] = dt_
                du_HO = adv._stage_ho_fused(
                    geom, u, n_cg=0 if level == 1 else None)
            else:
                u_nbr = adv.gather_nbr(u)
                Ku, _ = geom_conv(geom["xs"], adv.v_nodes, u, adv._gc_tables,
                                  1.0, with_wdet=False)
                contrib = pam.face_full_apply(u[:, adv.bdr_dofs], u_nbr,
                                              adv.Bface, geom["wvn"])
                du_HO = asm.scatter_face_add(Ku, contrib, adv.bdr_dofs)
                if level >= 2:
                    du_HO = pam.mass_solve_gl(du_HO, geom["wdet"], adv.Bgl,
                                              adv.A_gl2b)
            out = du_HO
            if level >= 3:
                if "du_LO_fused" in geom:
                    du_LO = geom["du_LO_fused"]
                else:
                    du_LO = lom.mass_based_avg(u, du_HO, dt_, geom["detJ"],
                                               adv.w_q, adv.Bu)
                # keep du_HO alive (the real stage feeds it to FCT)
                out = du_LO + 1e-30 * du_HO
            if level >= 4:
                el_min, el_max = bnd.elements_min_max(u)
                x_min, x_max = adv.compute_bounds(el_min, el_max)
                # keep the bounds alive without changing the magnitude
                out = out + 1e-30 * (x_min + x_max)
            return torch.stack([out]), aux0

        return f

    return stage_prefix


def _traced_loop_time(step, S, dt, n_steps):
    """(device seconds, host wall seconds, trace, launches) of one
    n_steps loop: the host wall of a plain pass, the device time (sum of
    the device events) of a traced one; launches counts the port kernels'
    launches in the traced pass."""
    run = _loop(step, S, dt, n_steps)
    run()                                           # warm
    t0 = time.perf_counter()
    run()
    host = time.perf_counter() - t0
    tr, launches = trc.capture_counted(run)
    return trc.device_time_of_loop(tr), host, tr, launches


def _measure_phases_trace(adv, u0, dt, n_steps, rk):
    """The ablation timed by DEVICE time per level; the fixed per-loop host
    cost is the real (level 5) loop's host wall less its device time. The
    level 5 trace's loop report and kernel counts are kept under "trace"."""
    S = torch.stack([u0])
    stage_prefix = _make_stage_prefix(adv, u0.dtype)
    stages = STAGES[rk]
    times = {"level_s_per_stage": {}}
    prev = 0.0
    for level in range(6):
        step = steppers.make_rk_step(stage_prefix(level), rk)
        dev_s, host_s, tr, launches = _traced_loop_time(step, S, dt, n_steps)
        per_stage = dev_s / (n_steps * stages)
        times["level_s_per_stage"][level] = per_stage
        if level == 0:
            times["combine"] = per_stage
        else:
            times[LABELS[level]] = per_stage - prev
        if level == 5:
            times["wall_total"] = host_s
            times["device_total"] = dev_s
            times["dispatch_per_call"] = max(host_s - dev_s, 0.0)
            times["dispatch"] = times["dispatch_per_call"] / (
                n_steps * stages)
            # device-time repeat noise: trace the real loop once more
            dev2, _, _, _ = _traced_loop_time(step, S, dt, n_steps)
            times["noise_floor"] = abs(dev2 - dev_s) / (n_steps * stages)
            rep = trc.loop_report(tr, n_steps, stages)
            times["trace"] = dict(
                report=rep, kernel_events=trc.kernel_events(tr),
                launches=launches,
                # the profiler slows the host: against the untraced wall
                idle_share_untraced=1.0 - rep["busy_s"] / host_s)
        prev = per_stage
    times["pipeline_total"] = prev
    times["timing_source"] = "device_trace"
    return times


def measure_phases(adv, u0, dt, n_steps=10, reps=3, rk=3, device=None):
    """Composed-ablation phase times (seconds per stage) for the PA remap
    stage: combine, rhs, inv, lo, bounds, fct, the full per-stage time, the
    noise floor and each level's own time (`level_s_per_stage`). `device`
    (None: the card) must be the operator's: a CPU measurement is asked for
    by name. On the card each level is timed by its device time from a
    profiler trace; on the CPU by the host clock (`reps` applies there)."""
    assert adv.cfg.pa, "phase FOMs are reported for the PA hot path"
    device = resolve_device(device)
    if _indexed(device) != _indexed(adv.device):
        raise ValueError(f"measure_phases on {device}: the operator is on "
                         f"{adv.device}")
    if device.type == "cuda":
        out = _measure_phases_trace(adv, u0, dt, n_steps, rk)
        out["device"] = torch.cuda.get_device_name(device)
        return out
    S = torch.stack([u0])
    stage_prefix = _make_stage_prefix(adv, u0.dtype)
    stages = STAGES[rk]
    times = {"level_s_per_stage": {}}
    prev = 0.0
    noise = 0.0
    for level in range(6):
        step = steppers.make_rk_step(stage_prefix(level), rk)
        best, worst = _timed_loop(step, S, dt, n_steps, reps)
        per_stage = best / (n_steps * stages)
        times["level_s_per_stage"][level] = per_stage
        if level == 0:
            # every loop pays a fixed cost independent of its length; a
            # second length separates it from the per-stage combine work
            # (wall = a + b n). The fixed term is the same at every level,
            # so the level-to-level deltas cancel it.
            best4, _ = _timed_loop(step, S, dt, 4 * n_steps, reps)
            slope = (best4 - best) / (3 * n_steps * stages)
            times["combine"] = max(slope, 0.0)
            times["dispatch_per_call"] = max(best - slope
                                             * n_steps * stages, 0.0)
            times["dispatch"] = times["dispatch_per_call"] / (
                n_steps * stages)
        else:
            times[LABELS[level]] = per_stage - prev
        if level == 5:
            noise = (worst - best) / (n_steps * stages)
            times["wall_total"] = best
        prev = per_stage
    times["pipeline_total"] = prev        # == the real step loop
    times["noise_floor"] = noise
    times["timing_source"] = "host_wall"
    times["device"] = "cpu"
    return times


def print_fom_report(phase_times, ndofs, stages, total_wall=None):
    """The reference's report block (remhos.cpp:1938-1952). `stages` is
    RK stages x steps; FOMs are megadofs x stages / second per phase.
    The reference's stopwatches cover RHS/INV/LO/FCT only; bounds and
    integrator combine/scan overhead are reported as extra rows here."""
    T = {k: phase_times[k] * stages
         for k in ("rhs", "inv", "lo", "bounds", "fct", "combine")}
    disp = phase_times.get("dispatch_per_call", 0.0)
    total_ref = T["rhs"] + T["inv"] + T["lo"] + T["fct"]
    total_all = sum(T.values()) + disp
    ds = ndofs * stages
    noise = phase_times.get("noise_floor", 0.0) * stages
    # the mega kernel does not decompose: the ablation levels re-split it
    # and several deltas land at (or below) the repeat-to-repeat noise.
    # Clamp each phase to the noise floor so its FOM is a finite LOWER
    # BOUND (fom_noise_floor is the largest reportable value) instead of
    # a 1e30-scale artifact of dividing by ~0.
    floor = max(noise, 1e-7)
    clamped = {k: k in ("rhs", "inv", "lo", "bounds", "fct", "combine")
               and T[k] < floor for k in T}
    T = {k: max(v, floor) for k, v in T.items()}
    print("---")
    print(f"RHS    kernel time: {T['rhs']:.6g}")
    print(f"L2inv  kernel time: {T['inv']:.6g}")
    print(f"LO     kernel time: {T['lo']:.6g}")
    print(f"FCT    kernel time: {T['fct']:.6g}")
    print(f"Total  kernel time: {total_ref:.6g}")
    print(f"(extra buckets outside the reference's stopwatches: "
          f"bounds {T['bounds']:.6g}, RK combine/scan {T['combine']:.6g}, "
          f"fixed dispatch latency {disp:.6g}/dispatch)")
    if total_wall is not None:
        print(f"(cross-check: measured full-step wall {total_wall:.6g}, "
              f"phase-sum covers "
              f"{100.0 * total_all / max(total_wall, 1e-30):.0f}%)")
    print(f"(noise floor: {noise:.3g} s across repeats — phases below "
          f"this are upper bounds)")
    print("---")
    out = {}
    for k, label in (("rhs", "RHS"), ("inv", "INV"), ("lo", "LO "),
                     ("bounds", "BND"), ("fct", "FCT"),
                     ("combine", "RK ")):
        out[f"fom_{k}"] = 1e-6 * ds / T[k]
        if k in ("rhs", "inv", "lo", "fct"):
            mark = " (>= lower bound; delta below noise)" if clamped[k] \
                else ""
            print(f"FOM {label}: {out[f'fom_{k}']:.6g}{mark}")
    out["fom"] = 1e-6 * ds / max(total_ref, floor)
    out["fom_all"] = 1e-6 * ds / max(total_all, floor)
    out["fom_noise_floor"] = 1e-6 * ds / floor
    out["dispatch_ms_per_call"] = 1e3 * disp
    print(f"FOM:     {out['fom']:.6g}")
    print("(megadofs x time steps / second; any per-phase FOM equal to "
          f"fom_noise_floor={out['fom_noise_floor']:.4g} is a lower "
          "bound)\n---")
    return out
