#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (remhos_torch) on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py
It builds the CUDA kernels from the sources on first use, then:

1. prints the card's name and power limit (nvidia-smi);
2. builds every kernel library (one nvcc each, started together) and prints
   the build time and each library's ptxas lines;
3. holds every kernel against its plain PyTorch version on the card, on the
   same inputs from a numpy seed, at N=24, p=3 in 3D and on a 2D 16x16 mesh,
   in f32 and f64 (wdet and geom_conv also at the golden rows' shape, in
   step 9): the mega stage; the HO stage with and without its LO
   output and once with n_cg == 0; wdet; geom_conv; the HO stage from the
   nodes (kernel 5) with its defaults, n_cg=0, with_face=False and mode=-1;
   the element-local GL CG (kernel 6); the neighbour gather (kernel 7), bit
   for bit, on the mesh, on the same shape made periodic and on a layout
   whose block size is not a multiple of 8. Limits, relative to the largest
   entry of the plain result: du (and CG's x) 2e-4 (f32) and 1e-10 (f64);
   wdet, and geom_conv's Ku, 1e-5 (f32) and 1e-12 (f64). Each check prints
   the kernel's ms per launch (CUDA events), the plain version's, the bound
   (remhos_torch/utils/cost.py) and, for the gather, the ms of its one-call
   library equivalent (index_select);
4. drives the main path: bench.build_case(n=24, order=3, f32) and 320 RK3
   steps at dt = 0.2/320 with the mass closures, bench.verify and the 2-step
   f32-vs-f64 cross check; asserts that the mega stage ran on every stage;
5. drives path A, the non-mega fused stage at full width through
   driver.run: 24^3, p=3, product remap in f32 (closure on), 320 steps;
   asserts the HO stage's and wdet's launch counts, the mass losses and the
   closure's injection. Then the same in f64 with dt control (-dtc 1) for
   40 step attempts, which must roll back at least once and accept steps
   (in f32 the reference's dt estimate, with its 1e-12 threshold on du,
   rejects every dt, in the JAX package as here, so dt control runs in f64);
6. drives path B in f64: the IDP-RK3 product remap with -vb for 20 steps,
   which must end without a bounds violation at the reference's 1e-12
   tolerance, with its gates; and holds one limited stage's aux channel
   (dt ratio, violation count) from the kernel against the plain version's;
7. drives path C, the non-fused PA stage at full width: path A's run with
   -lo 3 (residual distribution), so every stage launches wdet once and
   geom_conv three times (HO u, LO u, HO us) and solves two global CGs;
   asserts the launch counts and path A's gates, prints the CG iterations
   per solve. Then path D in f64: -ho 2 -lo 4 -vb, one field, 20 steps (the
   Bernstein CG, the subcell weights, the monotonicity check), and one stage
   of path C split into its parts by CUDA events;
8. drives the measurement entry points: bench.run(phases=True, trace=True)
   on the main path, over 10 steps (the phase FOM report, the trace's kernel
   and glue time per stage, its top glue ops and the device's idle share),
   the phase ablation on a non-fused operator (path C's configuration, one
   field), the tools microbench and kernelbench at N=24, and one traced
   launch of each kernel. Every trace must hold as many events of each
   kernel as its launch counter advanced over the traced code;
9. holds wdet and geom_conv against their plain versions on the operator of
   each cheap remap -pa golden row outside the -lo 5 family (its own mesh,
   p=2, f64), then runs the row in f64 on the card against
   goldens/reference_goldens.json (5e-10 relative on mass and max u);
10. prints one JSON line per result, the wall seconds of each step and a
    `kernels` line;
11. ends with {"ok": true, "device": {...}}.

Every launch count is set to 0 just before a path and read just after. Any
failure raises and exits nonzero; without CUDA it exits 2 and prints no
result.
"""

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from remhos_torch import bench, bounds, driver, ops, pa, structured
from remhos_torch.config import RunConfig
from remhos_torch.operator import Advection, SolverConfig
from remhos_torch.ops import build
from remhos_torch.ops import gather_nbr as gn
from remhos_torch.ops import geom_conv as gc
from remhos_torch.ops import gl_cg as cg
from remhos_torch.ops import mega_stage as ms
from remhos_torch.ops import stage_ho as sh
from remhos_torch.ops import stage_ho_nodes as shn
from remhos_torch.ops import wdet as wd
from remhos_torch.tools import kernelbench, microbench
from remhos_torch.utils import fom
from remhos_torch.utils import trace as trc
from remhos_torch.utils.cost import (bound, gather_nbr_cost,
                                     gather_nbr_index, geom_conv_cost,
                                     gl_cg_cost, stage_cost,
                                     stage_ho_nodes_cost, wdet_cost)

# kernel against plain version, relative to max|du|: f64 round-off; f32
# 10x above the ~2e-5 FMA-ordering difference, below the ~2.5e-3 a lost
# Jacobi sweep would make
LIMITS = {torch.float32: 2e-4, torch.float64: 1e-10}
# wdet, relative to max|wdet|: a few Horner or dot roundings
WDET_LIMITS = {torch.float32: 1e-5, torch.float64: 1e-12}
# geom_conv's Ku, relative to max|Ku|: sums of a few hundred products of
# O(1) terms in another order
KU_LIMITS = {torch.float32: 1e-5, torch.float64: 1e-12}
N_MAIN, ORDER, STEPS = 24, 3, 320
SEED = 20261016

# path A: product remap, f32, through driver.run. t_final and dt are
# bench.py's known-good pair for the mesh motion (0.7, 0.2/320); max_tsteps
# cuts the 1/dt steps of the remap's pseudo-time.
PATH_A = dict(mesh="default", dim=3, elem_per_shard=N_MAIN ** 3, order=ORDER,
              problem=10, ho=3, lo=5, fct=2, pa=True, product_sync=True,
              dt_control=0, ode_solver=3, dtype="float32", t_final=0.7,
              dt=0.2 / 320, max_tsteps=STEPS, verbose=False)
# gates of path A (f32 state, Kahan combine, full f64 closure every step):
# u is pinned by the closure, us is not (f32 stage round-off, ~4e-8 a step).
# max s is recorded, not gated, in f32: s = us/u is taken wherever u exceeds
# the reference's EMPTY_ZONE_TOL = 1e-12, which in f32 includes dofs at
# round-off level, where the ratio is noise (the JAX package's f32 run shows
# the same; tests/test_torch_driver.py). Path B gates it in f64.
A_LIMITS = dict(mass_loss_u_rel=1e-6, mass_loss_us_rel=1e-4,
                closure_injected_rel=1e-4, max_u=1.0 + 1e-5, min_steps=320)
# path A in f64 with dt control, from a dt four times as large: attempts
# roll back (dt shrinks by 0.85 each) until the LO solution stays in its
# bounds. max s is recorded, not gated, here too: the standard RK
# recombination of product fields is not bounds-preserving in s (the IDP
# steppers of path B exist for that), in the plain version as in the kernel.
PATH_A_DTC = dict(PATH_A, dt_control=1, dtype="float64", dt=0.0025,
                  max_tsteps=40)
A_DTC_LIMITS = dict(mass_loss_u_rel=1e-8, mass_loss_us_rel=1e-8,
                    max_u=1.0 + 1e-10, min_steps=1, min_rollbacks=1)
# path B: IDP-RK3 product remap with -vb in f64, short. -vb holds every
# stage's dofs to their bounds at the reference's 1e-12, which only f64 can
# meet; a violation raises inside driver.run.
PATH_B = dict(PATH_A, dt_control=0, ode_solver=13, dtype="float64",
              verify_bounds=True, max_tsteps=20)
# s0 = 2 + sin sin <= 3, and the product limiter keeps s in its bounds
B_LIMITS = dict(mass_loss_u_rel=1e-8, mass_loss_us_rel=1e-8,
                max_s=3.0 + 1e-8, max_u=1.0 + 1e-10)
# path C: path A with the residual-distribution LO solution, which takes the
# configuration out of the fused family: per stage one wdet launch, three
# geom_conv launches (HO u, LO u, HO us) and two global CG solves. Gates as
# path A's.
PATH_C = dict(PATH_A, lo=3)
C_LIMITS = dict(A_LIMITS)
# path D: -ho 2 -lo 4 in f64, one field, with -vb: the Bernstein CG, the
# subcell weights, the stage checks at 1e-12 and the driver's global
# monotonicity check (which raise inside driver.run). Per stage one wdet and
# two geom_conv launches.
PATH_D = dict(PATH_A, ho=2, lo=4, product_sync=False, dtype="float64",
              verify_bounds=True, max_tsteps=20)
D_LIMITS = dict(mass_loss_u_rel=1e-8, max_u=1.0 + 1e-10, min_steps=20)
# steps of the main path's phase ablation and trace (the measurement step)
MEASURE_STEPS = 10
GOLDEN_ROWS = ("remap-cube3d-m3pa", "remap-cube3d-m4pa")
GOLDEN_TOL = 5e-10       # the baseline prints 10 significant digits


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps):
    """Mean device time of `fn` over `reps` calls, from CUDA events."""
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def compare(label, what, got, ref, limit):
    """max|got - ref| against limit * max|ref|; raises beyond it."""
    err = float((got - ref).abs().max())
    scale = float(ref.abs().max())
    if not (np.isfinite(err) and err <= limit * scale):
        raise RuntimeError(f"{label}: kernel disagrees with its plain "
                           f"version on {what}: max|diff| {err:g}, "
                           f"max|ref| {scale:g}, limit {limit:g}")
    return err, err / scale


def stage_inputs(adv, rng):
    """Random u from the seed and its gather and stencil on the card."""
    u = torch.as_tensor(rng.random((adv._poly.shape[0],
                                    adv._stage_tables["nd"])),
                        dtype=adv.dtype, device=adv.device)
    unbr = adv.gather_nbr(u).reshape(u.shape[0], -1)
    smin, smax = structured.overlap_stencil_T(
        *bounds.elements_min_max(u), adv.shape, adv.periodic, adv.masks)
    return u, unbr, smin, smax


def check_kernel(label, adv, dt, rng):
    """One mega stage, kernel vs plain version, on random u; raises beyond
    the limit. Returns the measured numbers."""
    dtype = adv.dtype
    u, unbr, smin, smax = stage_inputs(adv, rng)
    args = (0.1, dt, u, unbr, smin, smax, adv._poly, adv._stage_tables)
    n_cg = ms.default_sweeps(dtype)
    got = ms.mega_stage(*args)
    torch.cuda.synchronize()
    ref = ms.mega_stage_reference(*args, n_cg)
    torch.cuda.synchronize()
    err, rel = compare(label, "du", got, ref, LIMITS[dtype])
    res = dict(check=label, kernel="mega_stage", E=u.shape[0],
               max_abs_err=err, rel_err=rel, limit=LIMITS[dtype],
               ms=time_ms(lambda: ms.mega_stage(*args), 20),
               plain_ms=time_ms(
                   lambda: ms.mega_stage_reference(*args, n_cg), 5))
    res.update(bound(*stage_cost(adv._stage_tables, adv._poly, n_cg),
                     dtype))
    print(json.dumps(res), flush=True)
    return res


def check_stage_ho(label, adv, dt, rng, with_lo, n_cg=None, timed=True):
    """One HO stage, kernel vs plain version, on random u: du_HO, wdet and
    (with_lo) du_LO; raises beyond the limits."""
    dtype = adv.dtype
    tb, P = adv._stage_tables, adv._poly
    u, unbr, _, _ = stage_inputs(adv, rng)
    n = sh.default_sweeps(dtype) if n_cg is None else n_cg
    kw = dict(n_cg=n_cg, dt=dt, with_lo=with_lo)
    got = sh.stage_ho(0.1, u, unbr, P, tb, **kw)
    torch.cuda.synchronize()
    ref = sh.stage_ho_poly_reference(0.1, u, unbr, P, tb, n, dt=dt,
                                     with_lo=with_lo)
    torch.cuda.synchronize()
    names = ("du_HO", "wdet", "du_LO")[:len(ref)]
    limits = (LIMITS[dtype], WDET_LIMITS[dtype], LIMITS[dtype])
    errs = {k: compare(label, k, g, r, lim)
            for k, g, r, lim in zip(names, got, ref, limits)}
    res = dict(check=label, kernel="stage_ho", E=u.shape[0],
               with_lo=with_lo, n_cg=n,
               max_abs_err=max(errs[k][0] for k in names if k != "wdet"),
               rel_err={k: errs[k][1] for k in names},
               limit=LIMITS[dtype], wdet_limit=WDET_LIMITS[dtype])
    if timed:
        res.update(
            ms=time_ms(lambda: sh.stage_ho(0.1, u, unbr, P, tb, **kw), 20),
            plain_ms=time_ms(lambda: sh.stage_ho_poly_reference(
                0.1, u, unbr, P, tb, n, dt=dt, with_lo=with_lo), 5))
    res.update(bound(*stage_cost(tb, P, n, "ho", with_lo), dtype))
    print(json.dumps(res), flush=True)
    return res


def check_wdet(label, adv):
    """wdet kernel vs plain version at the nodes x0 + 0.3 v."""
    dtype = adv.dtype
    xs = (adv.x0_nodes + 0.3 * adv.v_nodes).contiguous()
    tb = adv._wdet_tables
    got = wd.wdet(xs, tb)
    torch.cuda.synchronize()
    ref = wd.wdet_reference(xs, tb)
    torch.cuda.synchronize()
    err, rel = compare(label, "wdet", got, ref, WDET_LIMITS[dtype])
    res = dict(check=label, kernel="wdet", E=xs.shape[0], max_abs_err=err,
               rel_err=rel, limit=WDET_LIMITS[dtype],
               ms=time_ms(lambda: wd.wdet(xs, tb), 20),
               plain_ms=time_ms(lambda: wd.wdet_reference(xs, tb), 5))
    res.update(bound(*wdet_cost(xs, tb), dtype))
    print(json.dumps(res), flush=True)
    return res


def nonfused_operator(base):
    """A non-fused operator (-lo 3) on the mesh, nodes and velocity of the
    fused operator `base`: it makes geom_conv's tables."""
    return Advection(base.disc, SolverConfig(problem=10, ho=3, lo=3, fct=2,
                                             pa=True),
                     base.x0_nodes, base.v_nodes, dtype=base.dtype,
                     device=base.device)


def check_geom_conv(label, adv, rng):
    """geom_conv kernel vs plain version at the nodes x0 + 0.3 v, the mesh
    velocity v and a random u: Ku and wdet, with the tables of the non-fused
    operator `adv`."""
    dtype = adv.dtype
    tb, v = adv._gc_tables, adv.v_nodes
    xs = adv.x0_nodes + 0.3 * v
    u = torch.as_tensor(rng.random((xs.shape[0], adv.disc.nd)), dtype=dtype,
                        device=adv.device)
    got = gc.geom_conv(xs, v, u, tb, 1.0)
    torch.cuda.synchronize()
    ref = gc.geom_conv_reference(xs, v, u, tb, 1.0)
    torch.cuda.synchronize()
    err, rel = compare(label, "Ku", got[0], ref[0], KU_LIMITS[dtype])
    _, wrel = compare(label, "wdet", got[1], ref[1], WDET_LIMITS[dtype])
    res = dict(check=label, kernel="geom_conv", E=xs.shape[0],
               max_abs_err=err, rel_err=rel, wdet_rel_err=wrel,
               limit=KU_LIMITS[dtype], wdet_limit=WDET_LIMITS[dtype],
               ms=time_ms(lambda: gc.geom_conv(xs, v, u, tb, 1.0), 20),
               plain_ms=time_ms(
                   lambda: gc.geom_conv_reference(xs, v, u, tb, 1.0), 5))
    res.update(bound(*geom_conv_cost(xs, u, tb), dtype))
    print(json.dumps(res), flush=True)
    return res


def check_stage_ho_nodes(label, adv, tb, rng, **kw):
    """Kernel 5 vs plain version at the nodes x0 + 0.3 v, the mesh velocity
    v, a random u and its trace: du (Ku with n_cg=0) and wdet; kw are the
    kernel's options (mode, n_cg, with_face). The f32 Bernstein mass inverse
    amplifies the different roundings of the kernel's fixed-order sums and
    the plain version's library products most without the face flux; at
    these shapes du stays inside LIMITS all the same."""
    dtype = adv.dtype
    v = adv.v_nodes
    xs = (adv.x0_nodes + 0.3 * v).contiguous()
    u = torch.as_tensor(rng.standard_normal((xs.shape[0], adv.disc.nd)),
                        dtype=dtype, device=adv.device)
    unbr = adv.gather_nbr(u).reshape(u.shape[0], -1)
    kw = dict(dict(mode=1.0, n_cg=None, with_face=True), **kw)
    n = sh.default_sweeps(dtype) if kw["n_cg"] is None else kw["n_cg"]
    got = shn.stage_ho_nodes(xs, v, u, unbr, tb, **kw)
    torch.cuda.synchronize()
    ref = shn.stage_ho_nodes_reference(xs, v, u, unbr, tb, **dict(kw, n_cg=n))
    torch.cuda.synchronize()
    err, rel = compare(label, "du", got[0], ref[0], LIMITS[dtype])
    _, wrel = compare(label, "wdet", got[1], ref[1], WDET_LIMITS[dtype])
    res = dict(check=label, kernel="stage_ho_nodes", E=u.shape[0],
               mode=kw["mode"], n_cg=n, with_face=kw["with_face"],
               max_abs_err=err, rel_err=rel, wdet_rel_err=wrel,
               limit=LIMITS[dtype], wdet_limit=WDET_LIMITS[dtype])
    res.update(
        ms=time_ms(lambda: shn.stage_ho_nodes(xs, v, u, unbr, tb, **kw), 20),
        plain_ms=time_ms(lambda: shn.stage_ho_nodes_reference(
            xs, v, u, unbr, tb, **dict(kw, n_cg=n)), 5))
    res.update(bound(*stage_ho_nodes_cost(xs, u, tb, n, kw["with_face"]),
                     dtype))
    print(json.dumps(res), flush=True)
    return res


def check_gl_cg(label, adv, tb, rng):
    """Kernel 6 vs plain version: a random right-hand side and wdet at the
    nodes x0 + 0.3 v (det J varies inside the elements, so the GL mass
    matrix is not diagonal). The bound counts the iterations each element
    takes on this data (from the plain version)."""
    dtype = adv.dtype
    xs = (adv.x0_nodes + 0.3 * adv.v_nodes).contiguous()
    wdet = wd.wdet_reference(xs, adv._wdet_tables)
    rhs = torch.as_tensor(rng.standard_normal((xs.shape[0], adv.disc.nd)),
                          dtype=dtype, device=adv.device)
    got = cg.gl_cg(rhs, wdet, tb)
    torch.cuda.synchronize()
    ref, its = cg.gl_cg_reference(rhs, wdet, tb, with_iterations=True)
    torch.cuda.synchronize()
    err, rel = compare(label, "x", got, ref, LIMITS[dtype])
    res = dict(check=label, kernel="gl_cg", E=rhs.shape[0], max_abs_err=err,
               rel_err=rel, limit=LIMITS[dtype],
               iterations_mean=float(its.double().mean()),
               iterations_max=int(its.max()),
               ms=time_ms(lambda: cg.gl_cg(rhs, wdet, tb), 20),
               plain_ms=time_ms(lambda: cg.gl_cg_reference(rhs, wdet, tb),
                                5))
    res.update(bound(*gl_cg_cost(rhs, wdet, tb, its), dtype))
    print(json.dumps(res), flush=True)
    return res


def check_gather_nbr(label, adv, rng):
    """Kernel 7 vs plain version, bit for bit, on random u: on the
    operator's (non-periodic) mesh, timed, with the one-call library
    equivalent (index_select of u with a zero slot over a flat index
    table); then on the same shape made periodic and on a layout whose
    block size is not a multiple of 8."""
    dtype, dev, dim = adv.dtype, adv.device, adv.disc.dim
    nd = adv.disc.nd
    nbr = torch.as_tensor(adv.disc.dofmaps.nbr_dof_local, dtype=torch.int32,
                          device=dev)
    odd = (5, 3, 7) if dim == 3 else (7, 5)
    layouts = [(tuple(adv.shape), tuple(adv.periodic)),
               (tuple(adv.shape), (True,) * dim),
               (odd, (True, False, True)[:dim])]
    res = dict(check=label, kernel="gather_nbr", E=adv.x0_nodes.shape[0],
               layouts=[], max_abs_err=0.0, rel_err=0.0, limit=0.0)
    for i, (shape, periodic) in enumerate(layouts):
        E = int(np.prod(shape))
        u = torch.as_tensor(rng.standard_normal((E, nd)), dtype=dtype,
                            device=dev)
        got = gn.gather_nbr(u, shape, periodic, nbr)
        ref = gn.gather_nbr_reference(u, shape, periodic, nbr)
        torch.cuda.synchronize()
        if not torch.equal(got, ref):
            raise RuntimeError(f"{label}: gather_nbr is not bit-identical "
                               f"to its plain version on {shape} "
                               f"{periodic}")
        res["layouts"].append(dict(shape=shape, periodic=periodic,
                                   bit_identical=True))
        if i == 0:
            idx = gather_nbr_index(shape, periodic, nbr, nd, dev).reshape(-1)
            u_pad = torch.cat([u.reshape(-1), u.new_zeros(1)])
            lib = u_pad.index_select(0, idx).reshape(E, -1)
            if not torch.equal(lib, ref):
                raise RuntimeError(f"{label}: the index_select equivalent "
                                   "is not the gather")
            res.update(
                ms=time_ms(lambda: gn.gather_nbr(u, shape, periodic, nbr),
                           50),
                plain_ms=time_ms(lambda: gn.gather_nbr_reference(
                    u, shape, periodic, nbr), 20),
                library_ms=time_ms(lambda: u_pad.index_select(0, idx), 50))
            res.update(bound(*gather_nbr_cost(u, idx.reshape(E, -1)), dtype))
    print(json.dumps(res), flush=True)
    return res


def new_kernel_checks(tag, size, prec, adv, rng, out):
    """Kernels 5-7 against their plain versions on one operator: kernel 5
    with its defaults, n_cg=0, with_face=False and mode=-1; kernel 6;
    kernel 7. Results go into out[kernel][key]."""
    key = f"{tag}_{prec}"
    tb = shn.stage_ho_nodes_tables(adv.disc, adv.dtype, adv.device)
    k5 = out.setdefault("stage_ho_nodes", {})
    k5[key] = check_stage_ho_nodes(f"{size} {prec}", adv, tb, rng)
    for opt, kw in (("n_cg0", dict(n_cg=0)), ("noface", dict(with_face=False)),
                    ("mode-1", dict(mode=-1.0))):
        k5[f"{key}_{opt}"] = check_stage_ho_nodes(
            f"{size} {prec} {opt}", adv, tb, rng, **kw)
    out.setdefault("gl_cg", {})[key] = check_gl_cg(f"{size} {prec}", adv, tb,
                                                   rng)
    out.setdefault("gather_nbr", {})[key] = check_gather_nbr(
        f"{size} {prec}", adv, rng)


def expect_counts(path, want):
    """The seven launch counts against `want` (a kernel it leaves out: 0)."""
    got = ops.launch_counts()
    want = {k: want.get(k, 0) for k in ops.KERNELS}
    if got != want:
        raise RuntimeError(f"{path}: kernel launches {got}, expected {want}")
    return got


def gate(path, name, value, limit, least=False):
    ok = value >= limit if least else value <= limit
    if not (np.isfinite(value) and ok):
        raise RuntimeError(f"{path}: {name} = {value:g} is "
                           f"{'below' if least else 'above'} its limit "
                           f"{limit:g}")


def fused_launches(attempts, fields):
    """Launches of a non-mega fused run: the HO stage once per field and
    stage, wdet for the two mass reports."""
    return dict(mega_stage=0, stage_ho=fields * bench.STAGES * attempts,
                wdet=2, geom_conv=0)


def nonfused_launches(attempts, fields):
    """Launches of a non-fused run with a residual-distribution LO solution:
    per stage wdet once and geom_conv once per field for the HO solution
    plus once for the LO solution of u; wdet twice more for the mass
    reports."""
    stages = bench.STAGES * attempts
    return dict(mega_stage=0, stage_ho=0, wdet=stages + 2,
                geom_conv=(fields + 1) * stages)


def run_driver_path(path, cfg_kw, limits, device, launches=fused_launches):
    """One driver.run with its launch counts and gates; returns the
    record."""
    cfg = RunConfig(device=str(device), **cfg_kw)
    fields = 2 if cfg.product_sync else 1
    ops.reset_launch_counts()
    res = driver.run(cfg)
    n = expect_counts(path, launches(res.steps_total, fields))
    mass0_u = res.final_mass_u + res.mass_loss_u
    mass0_us = res.final_mass_us + res.mass_loss_us if fields == 2 else 1.0
    # mass_loss is |m0 - mT|: m0 is one of mT +- loss; either gives the same
    # relative loss to first order
    rec = dict(path=path, dtype=cfg.dtype, ode_solver=cfg.ode_solver,
               dt_initial=cfg.dt, dt_final=res.dt, t_final=cfg.t_final,
               t_reached=res.t, steps=res.steps,
               steps_total=res.steps_total,
               rollbacks=res.steps_total - res.steps,
               wall_s=res.timers["wall_s"],
               ms_per_step=1e3 * res.timers["wall_s"] / res.steps_total,
               ndofs_per_field=N_MAIN ** 3 * (ORDER + 1) ** 3,
               fields=fields,
               mass_loss_u_rel=res.mass_loss_u / abs(mass0_u),
               mass_loss_us_rel=res.mass_loss_us / abs(mass0_us),
               closure_injected_rel=res.mass_closure_injected_rel,
               max_u=res.max_u, max_s=res.max_s, launches=n, limits=limits)
    if res.cg_solves:
        # every iteration reads one comparison back from the device
        rec.update(cg_solves=res.cg_solves, cg_iterations=res.cg_iterations,
                   cg_iterations_per_solve=res.cg_iterations / res.cg_solves,
                   cg_syncs_per_stage=(res.cg_iterations + res.cg_solves)
                   / (bench.STAGES * res.steps_total))
    # the reference's stage counting, per field: with -ps two fields advance
    # in every stage, so the work per stage is twice the main path's
    rec["MDOF_stages_per_s"] = (1e-6 * rec["ndofs_per_field"] * bench.STAGES
                                * res.steps_total / res.timers["wall_s"])
    print(json.dumps(rec), flush=True)
    for name, limit in limits.items():
        if name in ("min_steps", "min_rollbacks"):
            gate(path, name[4:], rec[name[4:]], limit, least=True)
        else:
            gate(path, name, rec[name], limit)
    return rec


def run_golden_rows(device, rng, wdet_checks, gc_checks):
    """The cheap remap -pa golden rows of the non-fused path, to the end in
    f64 on the card, against the reference's printed mass and max u. A row
    gives wdet and geom_conv another shape than paths A-D (its own mesh,
    p=2), so both are first held against their plain versions on the row's
    own operator; the checks go into `wdet_checks` and `gc_checks`."""
    path = Path(__file__).resolve().parent / "goldens" / \
        "reference_goldens.json"
    rows = {r["name"]: r for r in json.loads(path.read_text())["runs"]}
    recs = []
    for name in GOLDEN_ROWS:
        row = rows[name]
        cfg = RunConfig(verbose=False, device=str(device), **row["cfg"])
        adv, _ = driver.build_operator(cfg)
        label = f"{name} {cfg.mesh} p={cfg.order} f64"
        wdet_checks[name] = check_wdet(label, adv)
        gc_checks[name] = check_geom_conv(label, adv, rng)
        del adv
        ops.reset_launch_counts()
        res = driver.run(cfg)
        n = expect_counts(name, nonfused_launches(res.steps_total, 1))
        rec = dict(golden=name, steps=res.steps, mass=res.final_mass_u,
                   golden_mass=row["mass"], max_u=res.max_u,
                   golden_max=row["max"], wall_s=res.timers["wall_s"],
                   cg_iterations_per_solve=res.cg_iterations / res.cg_solves,
                   launches=n, tol=GOLDEN_TOL)
        print(json.dumps(rec), flush=True)
        for what, got, want in (("mass", res.final_mass_u, row["mass"]),
                                ("max u", res.max_u, row["max"])):
            if not abs(got - want) <= GOLDEN_TOL * max(abs(got), abs(want)):
                raise RuntimeError(f"{name}: {what} {got:.12g} is not the "
                                   f"golden {want:.10g}")
        recs.append(rec)
    return recs


def split_nonfused_stage(device):
    """Where one stage of path C goes, by CUDA events around each part (the
    parts with a CG solve include its reads back to the host): the whole
    stage of two fields; the stage geometry (one wdet launch inside); per
    field the HO solution, of which geom_conv and the CG solve; the
    residual-distribution LO solution of u (one geom_conv inside); and
    limit_mult given dS (the LO solution, bounds, ClipScale and the product
    limiter)."""
    f32 = torch.float32
    case = bench.build_case(N_MAIN, ORDER, f32, device, n_steps=STEPS)
    adv = Advection(case.disc, SolverConfig(problem=10, ho=3, lo=3, fct=2,
                                            pa=True, product_sync=True),
                    case.adv.x0_nodes, case.adv.v_nodes, dtype=f32,
                    device=device)
    u, t, dt = case.u0, 0.1, case.dt
    S = torch.stack([u, 2.0 * u])
    geom = adv.geometry(t)
    stage = adv.stage_function()
    dS = adv.mult_unlimited(t, dt, S, geom=geom)
    rhs = pa.mass_action(dS[0], geom["wdet"], adv.Bu)
    parts = dict(
        stage=lambda: stage(t, dt, S),
        geometry=lambda: adv.geometry(t),
        ho_solution=lambda: adv.ho_solution(geom, u),
        geom_conv=lambda: adv.conv_volume(geom, u),
        cg_solve=lambda: pa.mass_solve_gl(rhs, geom["wdet"], adv.Bgl,
                                          adv.A_gl2b),
        lo_solution=lambda: adv.lo_solution(geom, u),
        limit_mult=lambda: adv.limit_mult(t, dt, S, dS, geom=geom))
    rec = {"check": "path C stage split, 3d N=%d f32, ms" % N_MAIN}
    rec.update({name: time_ms(fn, 20) for name, fn in parts.items()})
    stats = {}
    pa.mass_solve_gl(rhs, geom["wdet"], adv.Bgl, adv.A_gl2b, stats=stats)
    rec["cg_iterations"] = stats["iterations"]
    print(json.dumps(rec), flush=True)
    return rec


def trace_seven_kernels(case, rng):
    """One launch of each of the seven kernels, at N=24 f32, under the
    profiler: the trace must hold one device event of each (the kernels
    are launched through ctypes, outside any aten op). Returns the events
    and each kernel's device ms from the trace: the kernel alone, where the
    CUDA-event times of phase 3 include the wrapper's host work whenever
    that is longer."""
    adv = case.adv
    u, unbr, smin, smax = stage_inputs(adv, rng)
    P, tb = adv._poly, adv._stage_tables
    nf_adv = nonfused_operator(adv)
    tbn = shn.stage_ho_nodes_tables(adv.disc, adv.dtype, adv.device)
    xs = (adv.x0_nodes + 0.3 * adv.v_nodes).contiguous()
    v = adv.v_nodes
    nbr = torch.as_tensor(adv.disc.dofmaps.nbr_dof_local, dtype=torch.int32,
                          device=adv.device)

    def seven():
        ms.mega_stage(0.1, case.dt, u, unbr, smin, smax, P, tb)
        sh.stage_ho(0.1, u, unbr, P, tb)
        wdet = wd.wdet(xs, adv._wdet_tables)
        gc.geom_conv(xs, v, u, nf_adv._gc_tables, 1.0)
        shn.stage_ho_nodes(xs, v, u, unbr, tbn, mode=1.0)
        cg.gl_cg(u, wdet, tb)
        gn.gather_nbr(u, adv.shape, adv.periodic, nbr)

    seven()                                   # built and warm
    tr, launches = trc.capture_counted(seven)
    events = trc.check_kernel_events(tr, launches, "seven kernels")
    if set(events.values()) != {1}:
        raise RuntimeError(f"seven kernels: trace events {events}")
    by_name = trc.loop_report(tr, 1, 1)["kernel_s_per_stage_by_name"]
    return events, {k: 1e3 * v for k, v in by_name.items()}


def measurement_phase(device, rng):
    """The port's measurement entry points on the card: bench.run with the
    phase ablation and the trace on the main path; measure_phases on a
    non-fused operator (path C's configuration, one field); microbench and
    kernelbench at N=24 p=3 f32; one traced launch of each kernel. Every
    trace's kernel events must equal the launch counters over it."""
    f32 = torch.float32
    case = bench.build_case(N_MAIN, ORDER, f32, device, n_steps=STEPS)
    # fewer steps for the ablation and the trace than bench.py's 40: each
    # level runs warm, untraced and traced, inside the time limit
    rec = bench.run(case, phases=True, trace=True,
                    measure_steps=MEASURE_STEPS)
    if rec["trace_kernel_events"] != rec["trace_launches"]:
        raise RuntimeError(f"main path trace: kernel events "
                           f"{rec['trace_kernel_events']}, launches "
                           f"{rec['trace_launches']}")
    want = bench.STAGES * rec["trace_steps"]
    if rec["trace_launches"]["mega_stage"] != want:
        raise RuntimeError(f"main path trace: {rec['trace_launches']}, "
                           f"expected {want} mega_stage launches")
    main = dict(check="main path: phases and trace, 3d N=%d f32" % N_MAIN,
                **{k: rec[k] for k in (
                    "ms_per_stage", "MDOF_stages_per_s", "kernel_us_per_stage",
                    "glue_us_per_stage", "glue_breakdown_us", "idle_share",
                    "idle_share_untraced", "trace_kernel_events",
                    "hbm_bytes_per_stage_model",
                    "phase_s_per_stage", "phase_timing_source", "fom",
                    "fom_all", "fom_rhs", "fom_inv", "fom_lo", "fom_fct",
                    "dispatch_ms_per_call")})
    print(json.dumps(main), flush=True)

    adv = nonfused_operator(case.adv)
    n_steps = 5
    ph = fom.measure_phases(adv, case.u0, case.dt, n_steps=n_steps,
                            device=device)
    fom.print_fom_report(ph, case.ndofs, n_steps * bench.STAGES,
                         total_wall=ph.get("wall_total"))
    t = ph["trace"]
    if t["kernel_events"] != t["launches"]:
        raise RuntimeError(f"non-fused trace: kernel events "
                           f"{t['kernel_events']}, launches {t['launches']}")
    rep = t["report"]
    nonfused = dict(
        check="non-fused operator (-lo 3, one field): phases and trace, "
              "3d N=%d f32" % N_MAIN,
        phase_s_per_stage={k: ph[k] for k in (
            "combine", "rhs", "inv", "lo", "bounds", "fct", "pipeline_total",
            "noise_floor", "dispatch")},
        wall_s_per_stage=ph["wall_total"] / (n_steps * bench.STAGES),
        kernel_us_per_stage=rep["kernel_s_per_stage"] * 1e6,
        glue_us_per_stage=rep["glue_s_per_stage"] * 1e6,
        glue_breakdown_us={k: v * 1e6 for k, v in
                           list(rep["buckets_s_per_stage"].items())[:5]},
        idle_share=rep["idle_share"],
        idle_share_untraced=t["idle_share_untraced"],
        trace_kernel_events=t["kernel_events"])
    print(json.dumps(nonfused), flush=True)
    del adv

    # shorter loops than the tools' own (30 and 50): the time limit
    ops.reset_launch_counts()
    mb = microbench.main(device, n_inner=10)
    kb = kernelbench.main(device, n_inner=20)
    tools = dict(check="microbench and kernelbench, 3d N=%d f32, ms" % N_MAIN,
                 microbench=mb, kernelbench=kb, launches=ops.launch_counts())
    print(json.dumps(tools), flush=True)
    seven, tools["trace_ms"] = trace_seven_kernels(case, rng)
    print(json.dumps(dict(check="one traced launch of each kernel",
                          trace_kernel_events=seven,
                          trace_ms=tools["trace_ms"])), flush=True)
    return main, nonfused, tools


def check_vb_stage(device):
    """The -vb and dt-control side channel in f64 at full width: one limited
    stage of two fields, aux = [dt ratio, -violations] with du_HO from the
    kernel against the same with du_HO from the plain version: dS to the
    f64 limit, the ratio to 1e-9, the violation count equal."""
    case = bench.build_case(N_MAIN, ORDER, torch.float64, device,
                            n_steps=STEPS)
    scfg = SolverConfig(problem=10, ho=3, lo=5, fct=2, pa=True,
                        product_sync=True, verify_bounds=True, dt_control=1,
                        ode_solver=13)
    adv = Advection(case.disc, scfg, case.adv64.x0_nodes,
                    case.adv64.v_nodes, dtype=torch.float64, device=device)
    u = case.u0_64
    S = torch.stack([u, 2.0 * u])
    t, dt = 0.1, case.dt
    dS = adv.mult_unlimited(t, dt, S)
    n_cg = sh.default_sweeps(torch.float64)
    dS_ref = torch.stack([sh.stage_ho_poly_reference(
        t, S[k], adv.gather_nbr(S[k]).reshape(u.shape[0], -1), adv._poly,
        adv._stage_tables, n_cg)[0] for k in range(2)])
    out, aux = adv.limit_mult(t, dt, S, dS)
    out_ref, aux_ref = adv.limit_mult(t, dt, S, dS_ref)
    err, rel = compare("-vb stage", "dS", out, out_ref,
                       LIMITS[torch.float64])
    (ratio, nviol), (ratio_ref, nviol_ref) = aux.tolist(), aux_ref.tolist()
    if nviol != nviol_ref or abs(ratio - ratio_ref) > 1e-9 * abs(ratio_ref):
        raise RuntimeError(f"-vb stage: aux {aux.tolist()} from the kernel, "
                           f"{aux_ref.tolist()} from the plain version")
    rec = dict(check="-vb stage aux, 3d N=%d f64" % N_MAIN, dS_rel_err=rel,
               dt_ratio=ratio if np.isfinite(ratio) else None,
               dt_ratio_plain=ratio_ref if np.isfinite(ratio_ref) else None,
               violations=int(-nviol), violations_plain=int(-nviol_ref))
    print(json.dumps(rec), flush=True)
    return rec


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)

    # 1. the card
    card = card_line()
    print(card, flush=True)

    # 2. build every library, all compilers started together
    t0 = time.perf_counter()
    libs = build.build_all()
    build_s = time.perf_counter() - t0
    print(json.dumps({"build_s": build_s,
                      "libraries": {n: p.name for n, p in libs.items()},
                      "ptxas": {n: build.ptxas_report(n) for n in libs}}),
          flush=True)

    seconds = {"build": build_s}
    lap = [time.perf_counter()]

    def done(phase):
        now = time.perf_counter()
        seconds[phase] = now - lap[0]
        lap[0] = now

    # 3. kernels against plain versions, f32 and f64, N=24 3D and a 2D mesh
    rng = np.random.default_rng(SEED)
    # kernels 5-7 draw from their own stream: kernels 1-4 see the inputs
    # they saw before those checks existed
    rng_new = np.random.default_rng(SEED + 1)
    checks, ho_checks, wdet_checks, gc_checks = {}, {}, {}, {}
    new_checks = {}
    for tag, n, dim in (("3d", N_MAIN, 3), ("2d", 16, 2)):
        case = bench.build_case(n, ORDER, torch.float32, dev, n_steps=STEPS,
                                dim=dim)
        size = f"{tag} N={n}" if dim == 3 else f"{tag} {n}x{n}"
        for prec, adv in (("f32", case.adv), ("f64", case.adv64)):
            key = f"{tag}_{prec}"
            checks[key] = check_kernel(f"{size} {prec}", adv, case.dt, rng)
            for with_lo in (True, False):
                k2 = key + ("_lo" if with_lo else "")
                ho_checks[k2] = check_stage_ho(
                    f"{size} {prec} with_lo={with_lo}", adv, case.dt, rng,
                    with_lo)
            wdet_checks[key] = check_wdet(f"{size} {prec}", adv)
            gc_checks[key] = check_geom_conv(f"{size} {prec}",
                                             nonfused_operator(adv), rng)
            new_kernel_checks(tag, size, prec, adv, rng_new, new_checks)
        if dim == 3:
            ho_checks["3d_f32_ku"] = check_stage_ho(
                f"{size} f32 n_cg=0 with_lo=True", case.adv, case.dt, rng,
                True, n_cg=0, timed=False)
        del case
        torch.cuda.empty_cache()
    done("kernel checks")

    # 4. the main path, counted
    ops.reset_launch_counts()
    case = bench.build_case(N_MAIN, ORDER, torch.float32, dev,
                            n_steps=STEPS)
    rec = bench.run(case)
    # the cross check's 2 f32 and 2 f64 steps; verify's two lumped masses
    main_counts = expect_counts("main path", dict(
        mega_stage=bench.STAGES * (case.n_steps + 2 + 2), stage_ho=0,
        wdet=2, geom_conv=0))
    u, unbr, smin, smax = stage_inputs(case.adv, rng)
    adv = case.adv
    kernel_ms = time_ms(lambda: ms.mega_stage(
        0.1, case.dt, u, unbr, smin, smax, adv._poly, adv._stage_tables), 50)
    rec.update(kernel_ms_per_launch=kernel_ms, launches=main_counts,
               card=card)
    print(json.dumps(rec), flush=True)
    del case, adv, u, unbr, smin, smax
    torch.cuda.empty_cache()
    done("main path")

    # 5. path A: product remap, f32, through driver.run; then in f64 with
    # dt control
    rec_a = run_driver_path("A", PATH_A, A_LIMITS, dev)
    rec_d = run_driver_path("A f64 -dtc 1", PATH_A_DTC, A_DTC_LIMITS, dev)
    # 6. path B: IDP-RK3 product remap with -vb in f64; the stage's aux
    rec_b = run_driver_path("B", PATH_B, B_LIMITS, dev)
    check_vb_stage(dev)
    done("paths A and B")
    # 7. paths C and D: the non-fused PA stage; 8. its cheap golden rows
    rec_c = run_driver_path("C", PATH_C, C_LIMITS, dev, nonfused_launches)
    rec_path_d = run_driver_path("D", PATH_D, D_LIMITS, dev, nonfused_launches)
    split_nonfused_stage(dev)
    torch.cuda.empty_cache()
    done("paths C and D")
    # 8. the measurement entry points: phases, traces, the tools
    _, _, tools = measurement_phase(dev, rng_new)
    torch.cuda.empty_cache()
    done("measurement")
    # 9. the cheap golden rows of the non-fused stage
    run_golden_rows(dev, rng, wdet_checks, gc_checks)
    done("golden rows")
    print(json.dumps({"seconds": seconds}), flush=True)

    # 10. every ported kernel: `launches` on its own path (mega stage: the
    # main path; stage_ho: path A; wdet and geom_conv: path C; kernels 5-7:
    # the tools, microbench and kernelbench), numbers at 3D N=24 f32
    def row(name, source, replaces, launches, c32, c64, all_checks, **more):
        keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")
        lib = more.pop("library_ms", None)
        more["trace_ms"] = tools["trace_ms"][name]
        return dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=launches, max_abs_err=c32["max_abs_err"],
            ms=more.pop("ms", c32["ms"]), plain_ms=c32["plain_ms"],
            bound_ms=c32["bound_ms"], bound_by=c32["bound_by"],
            library_ms=lib, f64={k: c64[k] for k in keys + (
                ("library_ms",) if lib is not None else ())},
            checks=[{k: c[k] for k in ("check", "max_abs_err", "rel_err",
                                       "limit")}
                    for c in all_checks.values()], **more)

    pk = "remhos_tpu/ops/pallas_kernels.py"
    kernels = [
        row("mega_stage", "remhos_torch/ops/csrc/mega_stage.cu", pk + ":889",
            main_counts["mega_stage"], checks["3d_f32"], checks["3d_f64"],
            checks, ms=kernel_ms),
        row("stage_ho", "remhos_torch/ops/csrc/stage_ho.cu", pk + ":809",
            rec_a["launches"]["stage_ho"], ho_checks["3d_f32_lo"],
            ho_checks["3d_f64_lo"], ho_checks,
            without_lo={k: ho_checks["3d_f32"][k]
                        for k in ("ms", "plain_ms", "bound_ms", "bound_by")},
            launches_path_a_dtc=rec_d["launches"]["stage_ho"],
            launches_path_b=rec_b["launches"]["stage_ho"]),
        row("wdet", "remhos_torch/ops/csrc/wdet.cu", pk + ":1130",
            rec_c["launches"]["wdet"], wdet_checks["3d_f32"],
            wdet_checks["3d_f64"], wdet_checks,
            launches_main_path=main_counts["wdet"],
            launches_path_a=rec_a["launches"]["wdet"],
            launches_path_d=rec_path_d["launches"]["wdet"]),
        row("geom_conv", "remhos_torch/ops/csrc/geom_conv.cu", pk + ":110",
            rec_c["launches"]["geom_conv"], gc_checks["3d_f32"],
            gc_checks["3d_f64"], gc_checks,
            launches_path_d=rec_path_d["launches"]["geom_conv"]),
    ]
    k5, k6, k7 = (new_checks[k] for k in ("stage_ho_nodes", "gl_cg",
                                          "gather_nbr"))
    tl = tools["launches"]
    kernels += [
        row("stage_ho_nodes", "remhos_torch/ops/csrc/stage_ho_nodes.cu",
            pk + ":490", tl["stage_ho_nodes"], k5["3d_f32"], k5["3d_f64"], k5,
            microbench_ms=tools["microbench"]["fused"],
            kernelbench_ms=tools["kernelbench"]),
        row("gl_cg", "remhos_torch/ops/csrc/gl_cg.cu", pk + ":209",
            tl["gl_cg"], k6["3d_f32"], k6["3d_f64"], k6,
            iterations_mean=k6["3d_f32"]["iterations_mean"],
            microbench_ms=tools["microbench"]["gl_cg kernel"],
            microbench_mass_solve_gl_ms=tools["microbench"]["mass_solve_gl"]),
        row("gather_nbr", "remhos_torch/ops/csrc/gather_nbr.cu",
            pk + ":1280", tl["gather_nbr"], k7["3d_f32"], k7["3d_f64"], k7,
            library_ms=k7["3d_f32"]["library_ms"],
            library="index_select of u with a zero slot over a flat index "
                    "table",
            microbench_ms=tools["microbench"]["gather kernel"]),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
