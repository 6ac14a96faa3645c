"""Micro-benchmark of the remap-stage pieces (dev tool).

The counterpart of tools/microbench.py. Each piece runs n times in a Python
loop on the card, the result fed back into the loop's state so that every
iteration depends on the last, synchronized at the end; the best of three
such loops, per iteration, is printed. The lines and their order are the
JAX tool's, with two more:
- the neighbour gather kernel (kernel 7, `ops.gather_nbr`) beside the plain
  structured gather the operator runs;
- the element-local CG kernel (kernel 6, `ops.gl_cg`) beside the global CG
  `pa.mass_solve_gl`, on the same right-hand side.
The JAX tool's MB_BLOCKS sweeps the TPU block size of the fused stage; the
port's tiles are fixed at compile time, so it has no such knob and prints
one "fused" line. Its MB_FIT separates the fixed latency of one dispatched
TPU program from the per-iteration time; here every iteration is launched
from the host and the host's cost is part of what a caller pays, so the
loop's time per iteration is the number printed.

    python -m remhos_torch.tools.microbench      (BENCH_N=24, BENCH_P=3)
"""

from __future__ import annotations

import os
import time

import torch

from .. import bounds as bnd
from .. import fct as fctm
from .. import lo as lom
from .. import pa as pam
from .. import problems as prob
from .. import resolve_device
from .. import steppers
from ..discretization import build_discretization
from ..driver import integrate_mesh_velocity, project_bernstein
from ..mesh import make_cartesian_mesh
from ..operator import Advection, SolverConfig
from ..ops import gather_nbr as gn
from ..ops import gl_cg as cg
from ..ops import stage_ho_nodes as shn

N_INNER = 30


def scan_time(fn, u0, reps=3, n=N_INNER):
    """Per-iteration seconds of u -> u-shaped fn over a synchronized loop of
    n iterations, best of reps, after one warm-up loop."""
    def loop():
        c = u0
        for _ in range(n):
            c = c + 1e-12 * fn(c)
        if c.device.type == "cuda":
            torch.cuda.synchronize(c.device)
    loop()
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        loop()
        best = min(best, time.perf_counter() - t0)
    return best / n


def setup(device, w=torch.float32):
    """bench's case at BENCH_N, BENCH_P: the mesh, the fused operator, x0,
    v and u0 in the working type (the JAX tool's dt = 0.02)."""
    n = int(os.environ.get("BENCH_N", "24"))
    p = int(os.environ.get("BENCH_P", "3"))
    problem = 10
    mesh = make_cartesian_mesh(3, (n, n, n), (0, 0, 0), (1, 1, 1),
                               (False, False, False))
    disc = build_discretization(mesh, p)
    scfg = SolverConfig(problem=problem, ho=3, lo=5, fct=2, ode_solver=3,
                        pa=True)
    dt = 0.02
    f64 = torch.float64
    x0 = torch.as_tensor(mesh.x, dtype=f64, device=device)
    v = integrate_mesh_velocity(x0, problem, mesh.bb_min, mesh.bb_max, 0.7,
                                dt)
    u0, _ = project_bernstein(
        x0, disc.Bm_at_unodes,
        lambda x: prob.u0_function(problem, x, mesh.bb_min, mesh.bb_max))
    x0, v, u0 = x0.to(w), v.to(w), u0.to(w)
    adv = Advection(disc, scfg, x0, v, dtype=w, device=device)
    return disc, adv, x0, v, u0, dt


def main(device=None, n_inner=N_INNER):
    """Print the pieces' times at BENCH_N^3, p = BENCH_P, f32, on `device`
    (None: the card); returns them, in ms, by line."""
    device = resolve_device(device)
    w = torch.float32
    disc, adv, x0, v, u0, dt = setup(device, w)
    E, nd = u0.shape
    print(f"E={E} nd={nd} Q={len(disc.w_q)} fused_stage={adv._fused_stage}")
    out = {}

    def line(label, fn, **kw):
        ms = 1e3 * scan_time(fn, u0, n=n_inner, **kw)
        out[label.strip()] = ms
        print(f"{label} {ms:8.3f} ms", flush=True)

    tables = shn.stage_ho_nodes_tables(disc, w, device)
    xs = x0 + 0.1 * v
    nbr = torch.as_tensor(disc.dofmaps.nbr_dof_local, dtype=torch.int32,
                          device=device)

    unbr0 = adv.gather_nbr(u0).reshape(E, -1)
    line("gather_nbr     ", lambda u: adv.gather_nbr(u).reshape(E, -1)[:, :nd])
    line("gather kernel  ",
         lambda u: gn.gather_nbr(u, adv.shape, adv.periodic, nbr)[:, :nd])

    line("fused          ", lambda u: shn.stage_ho_nodes(
        xs, v, u, unbr0, tables, mode=1.0)[0])
    line("fused (n_cg=0) ", lambda u: shn.stage_ho_nodes(
        xs, v, u, unbr0, tables, mode=1.0, n_cg=0)[0])

    du_HO, wdet = shn.stage_ho_nodes(xs, v, u0, unbr0, tables, mode=1.0)
    w_q, Bu = adv.w_q, adv.Bu
    detJ = wdet / w_q[None, :]
    ml = pam.lumped_mass_pa(wdet, Bu)

    line("mass_based_avg ",
         lambda u: lom.mass_based_avg(u, u, dt, detJ, w_q, Bu))

    def bounds_f(u):
        el_min, el_max = bnd.elements_min_max(u)
        return adv.compute_bounds(el_min, el_max)[0]
    line("bounds         ", bounds_f)

    x_min, x_max = adv.compute_bounds(*bnd.elements_min_max(u0))
    line("clip_scale     ", lambda u: fctm.clip_scale(u, ml, u, 0.9 * u,
                                                      x_min, x_max, dt))
    line("mass_solve_gl  ", lambda u: pam.mass_solve_gl(
        u, wdet, tables["Bgl"], tables["A"]))
    line("gl_cg kernel   ", lambda u: cg.gl_cg(u, wdet, tables))

    f = adv.stage_function()
    line("full stage     ", lambda u: f(0.1, dt, u[None])[0][0])

    step = steppers.make_rk_step(f, 3)
    S = torch.stack([u0])

    def loop_steps():
        s = S
        for _ in range(10):
            s, _ = step(s, 0.1, dt)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    loop_steps()
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        loop_steps()
        best = min(best, time.perf_counter() - t0)
    out["RK3 10-step loop"] = 1e3 * best
    print(f"RK3 10-step loop {1e3 * best:8.3f} ms  "
          f"({1e3 * best / 30:.3f} ms/stage, FOM "
          f"{1e-6 * E * nd * 30 / best:.0f})")
    return out


if __name__ == "__main__":
    main()
