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
   step 9): the mega stage; its per-dof variant (bounds "dof", on the
   sparsity bounds of -bt 1), also against the "T" variant on the same
   inputs with the stencil expanded to dofs; its element-major variant
   (bounds "E", the [E, 3^dim] stencil of a sharded grid) against its plain
   version and bit for bit against "T" on the same stencil values, also at
   p = 2 and 4 (E_ORDERS); kernels 1 and 2 reading the bf16 va/vn stream
   (P16, f32, 3D and 2D) against their P16 plain versions evaluated in f64
   on the same bf16 values; the HO stage with and without its LO
   output and once with n_cg == 0; wdet; geom_conv; the HO stage from the
   nodes (kernel 5) with its defaults, n_cg=0, with_face=False and mode=-1;
   the element-local GL CG (kernel 6) with its defaults, with every 7th
   right-hand side row 0 and with n_iter=0; the neighbour gather (kernel
   7), bit for bit, on the mesh, on the same shape made periodic and on a
   layout whose block size is not a multiple of 8. Limits, relative to the
   largest entry of the plain result: du (and CG's x) 2e-4 (f32) and 1e-10
   (f64); wdet, and geom_conv's Ku, 1e-5 (f32) and 1e-12 (f64); f32 wdet
   (of kernels 3, 4 and 5) and geom_conv are held to their plain versions
   evaluated in f64 on the same
   inputs (the f32 plain version's dense sums of O(1) coordinates lie ~1e-5
   from that at 24^3, its distance is printed beside; the kernels contract
   coordinates relative to each element's first node). Each check prints
   the kernel's ms per launch (CUDA events), the plain version's, the bound
   (remhos_torch/utils/cost.py) and, for the gather, the ms of its one-call
   library equivalent (index_select), both by CUDA events over back-to-back
   calls (taken in turns) and as device time from a trace. geom_conv is
   also held and timed without its wdet output (with_wdet=False, as the
   non-fused stage calls it), and wdet and geom_conv at 3D N=24 f32 also by
   their device time from a trace. Then kernels 1, 2, 5 and 6 at the
   orders p = 1, 2, 4 and 5 (3D N=24 and 2D 16x16, f32 and f64; p = 1 and 5
   run the core's runtime-size instantiation), and wdet and geom_conv at
   p = 2 and 4 (mesh order 2) and at mesh orders 1 and 3 (p = 3; runtime
   sizes) on the same meshes, kernel 5 with its four options at mesh
   orders 1 and 3. The assembled stage's kernel (fa_assemble) on a curved
   3D mesh of mesh order 2 moved to t = 0.3, p=2, at N=24 and at the
   benchmark cell's N=64, in f64 and f32: det J, M, ml, K and the face
   blocks against the plain chain on nodes relative to each element's
   first node (in f32 evaluated in f64 on the same inputs) to 1e-13 (f64)
   and 1e-5 (f32) of each tensor's largest entry, its ms by CUDA events
   and from a trace, the plain chain's ms and the bound. The assembled
   stage's flux-based FCT kernel (fa_fct) on one stage of path G's
   configuration at p=2 (the assembled cell's) at N=24 and N=64, f64 and
   f32, one and two sweeps: du against the plain chain to 1e-13 of max|du|
   (f32: against the plain chain evaluated in f64 on the same inputs, no
   farther than twice the f32 plain chain lies), its ms by CUDA events and
   from a trace, the plain chain's ms and the bound. The monolithic
   solver's explicit-part kernel (mono_rd) on one explicit pass of the
   benchmark's transport cell (2048^2 p=1, `-mono 1 -si 2`) from a seeded
   random u, f64 and f32, as the cell runs it (the rate, no d_full) and
   with d_full, and on one of path H1 (192^2 p=2, `-mono 1 -si 1`, with
   d_full, as it runs): du and d_full against the plain chain to 1e-14 of
   their largest entry (f32: against the plain chain evaluated in f64, no
   farther than twice the f32 plain chain lies), its ms each way by CUDA
   events and from a trace, the plain chain's ms and the bound.
   The f32 stage kernels (1, 2, 5) are held to the plain version evaluated
   in f64 on the same inputs with the kernel's one Jacobi sweep (the plain
   version's own f32 result carries its own rounding, amplified by the
   Bernstein mass inverse; its distance is printed beside), at 2e-4; in 3D
   at p = 4 at kernel 5's f32 small-mesh rule, 1e-3, and at p = 5 no
   farther than the f32 plain version (`stage_limit`). Each f32 check also
   prints how far one Jacobi sweep fewer moves the f64 du
   (`lost_sweep_rel`): at 24^3 less than any of these limits;
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
   (dt ratio, violation count) from the kernel against the plain version's.
   Then path F: the main path's configuration with -bt 1 through
   driver.run (24^3, p=3, one field, f32 with the Kahan combine and the
   full closure, 320 steps): every stage one launch of kernel 1's per-dof
   variant (its variant counter must read 3 x 320, the "T" variant 0);
   gates on the mass loss, the injection and u within [min u0, max u0] to
   1e-5; prints ms a stage and MDOF·stages/s;
7. drives path C, the non-fused PA stage at full width: path A's run with
   -lo 3 (residual distribution), so every stage launches wdet once and
   geom_conv three times (HO u, LO u, HO us) and solves two global CGs;
   asserts the launch counts and path A's gates, prints the CG iterations
   per solve. Then path D in f64: -ho 2 -lo 4 -vb, one field, 20 steps (the
   Bernstein CG, the subcell weights, the monotonicity check), and one stage
   of path C split into its parts by CUDA events. Then path G, the
   assembled (FA) path at full width in f64: -ho 3 -lo 1 -fct 1 for 20
   steps and -ho 3 -lo 5 -fct 4 -bt 1 -dtc 1 for 20 attempts, no kernel
   launched but fa_assemble, once an assembly (three a step attempt and
   the two mass reports), and with -fct 1 fa_fct once a stage; gates as
   path D's; its peak device memory, and
   one stage split
   by CUDA events into the geometry and assembly, the HO solve, the LO
   solution, the bounds and the FCT;
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
   then the assembled path's golden rows in f64 through the golden runner
   (one or more of each family: `-ho 1|3`, `-lo 1|2|4|5`, `-fct 1|2|4`,
   product remap, IDP, dt control; FA_GOLDEN_ROWS; 5e-10, no kernel but
   fa_assemble on the remap rows and fa_fct on the `-fct 1` rows);
   then the entry points of the port:
   a. the benchmark record, `bench.main` in this process at full width
      (N=24, p=3, 320 steps, best of 4 windows, the 2-step f32-vs-f64
      cross check, the trace and the phase FOMs): it must be verified and
      kernel 1 must have launched 3 x 320 x 4 times over the timed
      windows; then its sharded loop over a group of one
      (BENCH_SHARDED=1, NCCL in this process, one window, no closure):
      verified against the open-mode drift budget, kernel 1 launched
      3 x 320 times;
   b. path E, transport at full width through driver.run: periodic-cube
      refined to 24^3, p=3, problem 0, `-ho 3 -lo 5 -fct 2 -pa` in f32 with
      the Kahan combine and the full closure (the mesh is all periodic),
      dt = 0.0025, 100 steps; gates on the relative mass loss, the
      closure's injection and u within [min u0, max u0] to f32 round-off;
      then `-ho 2 -lo 4` in f64 for 20 steps (the transport subcell
      weights). No kernel may launch: the JAX package routes transport
      through no Pallas kernel either;
   c. the four transport -pa golden rows in f64 on the card through
      `remhos_torch.tools.run_goldens` (5e-10), no kernel launched;
   d. the command line, `python -m remhos_torch` in a subprocess on the
      transport-ballsjacks-m3pa row: its `Final mass u` and `Max value u`
      lines against the golden at 5e-10;
   e. path H, the monolithic RD solver with the smoothness indicator
      through driver.run: periodic-square refined to 192^2 (36,864
      elements), p=2, problem 4, `-mono 2 -si 2`, f64, dt = 3e-4, 20 steps,
      then `-mono 1 -si 1`; gates: mass loss < 1e-11 and max u <= 1 + 1e-9
      (tests/test_driver.py::test_mono_subcell's); prints ms a step, the
      inner loop's iterations (mean and max) and read-backs per stage and
      the peak device memory; then one stage split by CUDA events (the
      indicator, the solver without its inner loop, the loop) and traced
      (device ms, device events and idle share of the stage);
   f. path I, 1D through driver.run: periodic-segment refined to 1,024
      elements, p=3, problem 0, `-ho 3 -lo 4 -fct 2` (assembled: the
      reference disables PA in 1D), dt = 2.5e-5, 200 steps, in f64 (mass
      loss < 1e-13, max u <= 1 + 1e-10: test_1d_transport's gates) and in
      f32 (the repaired residual distribution; the closure's injection
      < 1e-4, max u <= 1 + 1e-6); then one stage split and traced as H's;
   g. the seven golden rows paths H and I opened (`steady-mono1|2`,
      `transport-1d-m1`...`m5`) in f64 at 5e-10 through the golden runner,
      and `transport-ballsjacks-m2` in its f32 tier.
   No kernel and no kernel variant may launch on e-g but mono_rd, once
   an explicit pass of every `-mono 1` run (2D p=1 and 2: path H's `-mono 1
   -si 1` and `steady-mono1|2`): the JAX package runs -mono, -si and 1D
   through no Pallas kernel;
   h. path J, general meshes read back by path from MFEM files that
      `vis.mfem_mesh_text` writes (a temporary directory): J1, the main
      path's 24^3 box (mesh order 2, p=3) with every element's corner frame
      turned by a random cube rotation from the seed, -p 10 -ho 3 -lo 5
      -fct 2 -pa, dt = 0.2/320, in f64 for 100 steps against the unrotated
      structured run (final mass 1e-12 relative, max u 1e-11) and in f32
      for 320 steps with the Kahan combine and the full closure under path
      F's gates; every stage is one launch of kernel 1's per-dof variant
      (the CG-node overlap bounds of a general mesh), which is then held
      against its plain version on the rotated mesh's own inputs (f32 and
      f64); J2, the J1 mesh with -ho 2 -lo 4 -pa, f64, 20 steps, against
      the structured run, with wdet and geom_conv held against their plain
      versions on the rotated nodes; J3, inline-quad written at -rs 1 and
      read back at -rs 4 (128^2 elements through the general refinement),
      p=3, -p 14 -ho 3 -lo 5 -fct 2 -pa, f64, 100 steps against the registry
      mesh at -rs 5, with -save (meshHO_final.mesh read back by the general
      loader equals the final nodes to 1e-13; sltn_final.gf holds E*nd
      values), then 10 steps with -prof, which must write a trace. Each run
      prints its ms a step, its setup seconds and its launch counts;
   i. path K, sharded runs of the main path's configuration at full width
      (24^3, p=3): K1, one rank in this process (NCCL), f64 100 steps and
      f32 320 steps, each against the unsharded run (f64: 1e-13 in final
      mass and max u; f32, which runs without the closure: the open-mode
      drift budget and u within its initial range to 1e-5), every stage one
      launch of kernel 1's "E" variant and none of "T"; K2, 4 ranks sharing
      the card (gloo, every exchange staged through host memory, the bytes
      printed), z slabs and a (2, 2) grid, and K3, 5 ranks on the general
      route (one ghost element; kernel 1's per-dof variant, no "E" or "T"),
      f64, 20 steps, each against the unsharded run at 1e-13, in one spawn;
      then the harness entry `graft_entry.entry()` with no device: on the
      card, one step equal to the CPU step to 1e-12 of max|S|;
   j. the bf16 P16 stream: the record's f32 leg with BENCH_POLY_BF16=1
      (verified: the closure's injection budget and the 2-step cross check;
      its value printed beside the headline's of step 9a), every kernel-1
      launch reading P16; then path A with poly_bf16 for 40 steps, every
      kernel-2 launch reading P16, under path A's gates;
10. prints one JSON line per result, the wall seconds of each step and a
    `kernels` line (kernel 1's variants as rows of their own, `variant_of`
    "mega_stage": the per-dof one with its launches from path F, the
    element-major one from path K1 f32, P16 from its record leg; kernel 2's
    P16 row from path A P16; the per-dof variant, wdet and geom_conv also
    carry their launches and numbers on path J's general meshes);
11. ends with {"ok": true, "device": {...}}.

Every launch count is set to 0 just before a path and read just after. Any
failure raises and exits nonzero; without CUDA it exits 2 and prints no
result.
"""

import contextlib
import io
import itertools
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from remhos_torch import (bench, bounds, dofmaps, driver, mono, ops, pa,
                          umesh, umesh3d, vis)
from remhos_torch import geometry as geo
from remhos_torch import problems as prob
from remhos_torch import structured
from remhos_torch.config import RunConfig
from remhos_torch.discretization import build_discretization
from remhos_torch.mesh import load_mesh, make_cartesian_mesh
from remhos_torch.operator import Advection, SolverConfig
from remhos_torch.ops import build
from remhos_torch.ops import fa_assemble as fa
from remhos_torch.ops import fa_fct as ff
from remhos_torch.ops import gather_nbr as gn
from remhos_torch.ops import geom_conv as gc
from remhos_torch.ops import gl_cg as cg
from remhos_torch.ops import mega_stage as ms
from remhos_torch.ops import mono_rd as mr
from remhos_torch.ops import stage_ho as sh
from remhos_torch.ops import stage_core as core
from remhos_torch.ops import stage_ho_nodes as shn
from remhos_torch.ops import tables as tbl
from remhos_torch.ops import wdet as wd
from remhos_torch.ops.stage_core import as_dtype
from remhos_torch.parallel import launch
from remhos_torch.tools import kernelbench, microbench, run_goldens
from remhos_torch.utils import fom
from remhos_torch.utils import trace as trc
from remhos_torch.utils.cost import (bound, fa_assemble_cost, fa_fct_cost,
                                     gather_nbr_cost, gather_nbr_index,
                                     geom_conv_cost, gl_cg_cost, mono_rd_cost,
                                     stage_cost, stage_ho_nodes_cost,
                                     wdet_cost)

# kernel against plain version, relative to max|du|: f64 round-off; f32
# 10x above the ~2e-5 FMA-ordering difference
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
# path F: the main path's -ho 3 -lo 5 -fct 2 -pa with -bt 1 through
# driver.run: one field, so every stage is one launch of kernel 1's per-dof
# variant; f32 with the Kahan combine and the full closure as path A.
# Gates: path A's mass and injection limits, u within [min u0, max u0] to
# 1e-5 (bench.verify's f32 bounds tolerance)
PATH_F = dict(PATH_A, product_sync=False, bounds_type=1)
F_LIMITS = dict(mass_loss_u_rel=1e-6, closure_injected_rel=1e-4,
                bounds=1e-5, min_steps=STEPS)
# path G: the assembled (FA) path at full width, f64: the BLAST remap
# default -ho 3 -lo 1 -fct 1 (the *-m5 golden rows), 20 steps; then the
# sharpening configuration -ho 3 -lo 5 -fct 4 -bt 1 -dtc 1, 20 attempts.
# No kernel: the JAX package runs no Pallas kernel without -pa. Gates as
# path D's
PATH_G = dict(PATH_A, pa=False, ho=3, lo=1, fct=1, product_sync=False,
              dtype="float64", max_tsteps=20)
G_LIMITS = dict(mass_loss_u_rel=1e-8, max_u=1.0 + 1e-10, min_steps=20)
PATH_G_SHARPEN = dict(PATH_G, lo=5, fct=4, bounds_type=1, dt_control=1)
G_SHARPEN_LIMITS = dict(mass_loss_u_rel=1e-8, max_u=1.0 + 1e-10,
                        min_steps=1)
# the golden rows of the assembled path on the card, one or more of each
# solver family the run's time allows (f64, 5e-10)
FA_GOLDEN_ROWS = ("remap-cube3d-m5", "remap-cube3d-m1", "remap-cube3d-m2",
                  "readme-run11-cube3d", "sharpen-pacman-autodt",
                  "product-remap-idp3", "product-remap-idp2",
                  "product-remap-fe-fct", "transport-cube-m5",
                  "transport-cube-m1")
# the assembled stage's kernel: 3D meshes of N^3 elements (24 as the other
# checks, 64 as the benchmark's assembled cell), p=2 (the cell's order),
# the nodes moved to t = FA_T; limits relative to each tensor's largest
# entry (f32: against the plain chain evaluated in f64)
FA_SIZES = (24, 64)
FA_P = 2
FA_T = 0.3
FA_LIMITS = {torch.float64: 1e-13, torch.float32: 1e-5}
FA_OUTPUTS = ("detJ", "M", "ml", "K_elem", "bdrInt")
# the assembled stage's flux-based FCT kernel on one stage of path G's
# configuration at p = FA_P, N in FA_SIZES: du within FA_FCT_LIMIT of
# max|du| from the plain chain in f64 (the sums over a row run in another
# order); in f32 no farther from the plain chain evaluated in f64 than
# FA_FCT_F32_FACTOR times the f32 plain chain lies (both round alike but
# for that order, so either may lie the nearer)
FA_FCT_LIMIT = 1e-13
FA_FCT_F32_FACTOR = 2.0
# the monolithic explicit-part kernel (mono_rd) on one explicit pass of the
# benchmark's transport cell (`-m inline-quad -rs 9 -p 7 -o 1 -mono 1 -si
# 2`, 2048^2 p=1 quads) and of path H1 (PATH_H1: 192^2 p=2 quads, -si 1,
# problem 4, with d_full for the inner loop: the other instance that runs)
# from a seeded random u: du (and d_full) within
# MONO_RD_LIMIT of max|du| from the plain chain in f64 (K u by FMAs and the
# sums in another order than ATen's); in f32 no farther from the plain
# chain evaluated in f64 than FA_FCT_F32_FACTOR times the f32 plain chain
MONO_RD_CELL = dict(mesh="inline-quad", problem=7, rs_levels=9, order=1,
                    ho=0, lo=0, fct=0, mono=1, smth_ind=2, dt=1.5625e-4,
                    verbose=False)
MONO_RD_LIMIT = 1e-14
# steps of the main path's phase ablation and trace (the measurement step)
MEASURE_STEPS = 10
GOLDEN_ROWS = ("remap-cube3d-m3pa", "remap-cube3d-m4pa")
GOLDEN_TOL = 5e-10       # the baseline prints 10 significant digits
# step 9a: the record's knobs (bench.py's defaults, named)
RECORD_ENV = dict(BENCH_N=str(N_MAIN), BENCH_P=str(ORDER),
                  BENCH_STEPS=str(STEPS), BENCH_REPS="4")
# then the same loop sharded over a group of one (NCCL, in this process),
# one timed window
SHARDED_RECORD_ENV = dict(RECORD_ENV, BENCH_SHARDED="1", BENCH_REPS="1",
                          BENCH_TRACE="0", BENCH_PHASES="0")
# path E: transport at full width, f32, closure on (all periodic)
PATH_E = dict(mesh="periodic-cube", rs_levels=3, order=ORDER, problem=0,
              ho=3, lo=5, fct=2, pa=True, dtype="float32", dt=0.0025,
              t_final=1.0, max_tsteps=100, verbose=False)
# f32: bench.verify's bounds tolerance, path A's mass and injection limits
E_LIMITS = dict(mass_loss_u_rel=1e-6, closure_injected_rel=1e-4,
                bounds=1e-5)
PATH_E64 = dict(PATH_E, ho=2, lo=4, dtype="float64", max_tsteps=20)
E64_LIMITS = dict(mass_loss_u_rel=1e-12, bounds=1e-10)
TRANSPORT_ROWS = ("transport-ballsjacks-m3pa", "transport-ballsjacks-m4pa",
                  "transport-cube-m3pa", "transport-cube-m4pa")
CLI_ROW = "transport-ballsjacks-m3pa"
CLI_ARGV = ("-m", "periodic-square", "-p", "5", "-rs", "3", "-dt", "0.004",
            "-tf", "0.8", "-ho", "2", "-lo", "3", "-fct", "2", "-pa")
# path H: the monolithic RD solver with the smoothness indicator at full
# width, tests/test_driver.py::test_mono_subcell's case refined 16x
# (periodic-square -rs 6: 192^2 = 36,864 elements, p=2) with dt cut 16x, f64,
# 20 steps; then -mono 1 -si 1. The assembled path: no kernel but, with
# -mono 1, mono_rd once an explicit pass (the JAX package runs -mono and
# -si in XLA). Gates: that test's
PATH_H = dict(mesh="periodic-square", problem=4, rs_levels=6, order=2, ho=0,
              lo=0, fct=0, mono=2, smth_ind=2, dtype="float64", dt=3e-4,
              t_final=1.0, max_tsteps=20, verbose=False)
PATH_H1 = dict(PATH_H, mono=1, smth_ind=1)
H_LIMITS = dict(mass_loss_u=1e-11, max_u=1.0 + 1e-9)
# path I: 1D, periodic-segment -rs 8 (1,024 elements), p=3, -ho 3 -lo 4
# -fct 2 (assembled: the reference disables PA in 1D), dt = 2.5e-5, 200
# steps; in f64 with tests/test_driver.py::test_1d_transport's gates, then
# in f32 (the repaired residual distribution, Kahan combine and closure)
# within path A's closure budget
PATH_I = dict(mesh="periodic-segment", problem=0, rs_levels=8, order=3,
              ho=3, lo=4, fct=2, dtype="float64", dt=2.5e-5, t_final=1.0,
              max_tsteps=200, verbose=False)
PATH_I32 = dict(PATH_I, dtype="float32")
I_LIMITS = dict(mass_loss_u=1e-13, max_u=1.0 + 1e-10)
I32_LIMITS = dict(closure_injected_rel=1e-4, max_u=1.0 + 1e-6)
# the golden rows the tenth slice opened (f64, 5e-10), and the -lo 4 row
# that failed the f32 tier before the residual distribution's repair
SLICE10_ROWS = ("steady-mono1", "steady-mono2", "transport-1d-m1",
                "transport-1d-m2", "transport-1d-m3", "transport-1d-m4",
                "transport-1d-m5")
F32_ROWS = ("transport-ballsjacks-m2",)
# path J: general meshes at full width, read back by path from MFEM files
# the port's writer makes. J1: the main path's 24^3 box (mesh order 2,
# p=3) with every element's corner frame turned by a random cube rotation
# from the seed; -p 10 -ho 3 -lo 5 -fct 2 -pa at dt = 0.2/320, in f64 for
# 100 steps against the unrotated structured run, then in f32 for 320
# steps (the Kahan combine and the full closure) under path F's gates; on
# a general mesh the -bt 0 bounds are the CG-node overlap, so every stage
# is one launch of kernel 1's per-dof variant. J2: the J1 mesh with -ho 2
# -lo 4 -pa (kernels 3 and 4), f64, 20 steps, against the structured run.
# J3: inline-quad written at -rs 1 and read back at -rs 4 (the general
# quad refinement: 128^2 = 16,384 elements), p=3, -p 14 -ho 3 -lo 5 -fct 2
# -pa, f64, 100 steps, against the registry mesh at -rs 5, with -save;
# then 10 steps of it with -prof.
PATH_J1 = dict(PATH_F, bounds_type=0, dtype="float64", max_tsteps=100)
PATH_J1_F32 = dict(PATH_F, bounds_type=0)
PATH_J2 = dict(PATH_J1, ho=2, lo=4, max_tsteps=20)
PATH_J3 = dict(mesh="inline-quad", rs_levels=5, order=ORDER, problem=14,
               ho=3, lo=5, fct=2, pa=True, dtype="float64", t_final=0.7,
               dt=0.2 / 320, max_tsteps=100, verbose=False)
# the general run against the structured one: the same elements in other
# frames and numberings, so equal to round-off
J_LIMITS = dict(mass_rel=1e-12, max_u=1e-11)
# the written mesh read back, against the final nodes (%.16g text)
J_SAVE_LIMIT = 1e-13
# path K: sharded runs of the main path's configuration at full width
# (24^3, p=3, -p 10 -ho 3 -lo 5 -fct 2 -pa, dt = 0.2/320). K1: one rank,
# NCCL, in this process, against the unsharded run: f64 100 steps, then f32
# 320 steps (the sharded f32 run has no closure: the open-mode drift
# budget, K_DRIFT, gates it). K2: 4 ranks sharing the card (gloo), along z
# (4 slabs of 6) and on a (2, 2) grid; K3: 5 ranks, the general route
# (24 % 5 != 0: one ghost element); f64, 20 steps. The mesh is `-m default`
# with -epm 24^3 and the shards as shard_grid, so the mesh stays 24^3.
PATH_K = dict(mesh="default", dim=3, elem_per_shard=N_MAIN ** 3, order=ORDER,
              problem=10, ho=3, lo=5, fct=2, pa=True, t_final=0.7,
              dt=0.2 / 320, verbose=False)
PATH_K1 = dict(PATH_K, dtype="float64", max_tsteps=100)
PATH_K1_F32 = dict(PATH_K, dtype="float32", max_tsteps=STEPS)
PATH_K2 = dict(PATH_K, dtype="float64", max_tsteps=20)
K_GRIDS = (("K2 z", (4,)), ("K2 (2, 2)", (2, 2)), ("K3 general", (5,)))
# sharded against unsharded, final mass and max u (absolute), f64
K_LIMIT = 1e-13
# f32 bounds: bench.verify's tolerance
K_BOUNDS = 1e-5


def k_drift(n_steps, dt):
    """bench.verify's open-mode drift budget of an f32 run without closure
    (remhos_torch/bench.py; bench.py:314-338): the GCL term, the random walk
    and the systematic stage rounding."""
    gcl = n_steps * max(5e-7 * (dt / 0.02) ** 4, 3e-11)
    sys_rate = 8e-9 * max(1.0, dt / 6.25e-4)
    return gcl + 1e-7 * n_steps ** 0.5 + sys_rate * n_steps


# the bf16 P16 stream: the record's f32 leg with BENCH_POLY_BF16=1 (kernel
# 1), then path A with poly_bf16 for 40 steps (kernel 2: two fields), gates
# as path A's
P16_RECORD_ENV = dict(RECORD_ENV, BENCH_POLY_BF16="1", BENCH_TRACE="0",
                      BENCH_PHASES="0")
PATH_A16 = dict(PATH_A, poly_bf16=True, max_tsteps=40)
A16_LIMITS = dict(A_LIMITS, min_steps=40)
# the orders kernels 1, 2 and 5 are also held at (p=3: step 3's checks);
# p = 2-4 are compiled sizes of the core, p = 1 and 5 its runtime sizes
ORDERS = (1, 2, 4, 5)
# the other orders kernel 1's "E" variant is held at (p=3: step 3's)
E_ORDERS = (2, 4)
# f32 stage kernels in 3D at p >= 4 (`stage_limit`)
F32_HIGH_ORDER_LIMIT = 1e-3
# the (p, mesh order) pairs wdet and geom_conv are also held at (p=3, mesh
# order 2: step 3's checks); p = 2 and 4 at mesh order 2 are compiled sizes
# of their mesh geometry, mesh orders 1 and 3 its runtime sizes
MESH_CASES = ((2, 2), (4, 2), (3, 1), (3, 3))


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


def hold(label, what, got, ref, ref64, limit):
    """A stage kernel's output `got` against its plain version; raises
    beyond `limit`. ref64 None (f64, and f32 wdet): against the plain
    version `ref` in the working type. f32:
    against `ref64`, the plain version evaluated in f64 on the same inputs
    with the kernel's sweep count: the plain version's own f32 result `ref`
    carries its own rounding, amplified by the Bernstein mass inverse; limit
    None holds the kernel no farther from ref64 than `ref` lies. Returns
    (max abs err, rel err, the plain f32 result's rel err from ref64, or
    None)."""
    if ref64 is None:
        return (*compare(label, what, got, ref, limit), None)
    f64 = torch.float64
    plain_rel = float((ref.to(f64) - ref64).abs().max()
                      / ref64.abs().max())
    if limit is None:
        limit = plain_rel
    return (*compare(label, what, got.to(f64), ref64, limit), plain_rel)


def stage_limit(adv):
    """The limit of a stage kernel's du on operator `adv` (`hold`): LIMITS,
    but in f32 in 3D, where f32 rounding, amplified by the Bernstein mass
    inverse, puts neither the kernel nor the plain version within 2e-4 of
    the f64 evaluation: at p = 4 kernel 5's f32 small-mesh rule, 1e-3; at
    p >= 5, where the f32 plain version lies 1e-2 off, None: no farther
    than the f32 plain version."""
    if adv.dtype == torch.float32 and adv.disc.dim == 3:
        if adv.disc.p >= 5:
            return None
        if adv.disc.p == 4:
            return F32_HIGH_ORDER_LIMIT
    return LIMITS[adv.dtype]


def lost_sweep_rel(t, u64, unbr64, P64, tb64, n_cg):
    """How far one Jacobi sweep fewer moves du_HO, relative to max|du_HO|:
    the f64 plain core with n_cg - 1 sweeps against n_cg, on the same
    inputs. An f32 limit sees a lost sweep only below it."""
    Ku, wdet = core.poly_stage_core_reference(t, u64, unbr64, P64, tb64, 0)
    full = core.jacobi_gl_inverse(Ku, wdet, tb64, n_cg)
    lost = core.jacobi_gl_inverse(Ku, wdet, tb64, n_cg - 1)
    return float((lost - full).abs().max() / full.abs().max())


def stage_inputs(adv, rng):
    """Random u from the seed and its gather and stencil on the card."""
    u = torch.as_tensor(rng.random((adv._poly.shape[0],
                                    adv._stage_tables["nd"])),
                        dtype=adv.dtype, device=adv.device)
    unbr = adv.gather_nbr(u).reshape(u.shape[0], -1)
    smin, smax = structured.overlap_stencil_T(
        *bounds.elements_min_max(u), adv.shape, adv.periodic, adv.masks)
    return u, unbr, smin, smax


def check_kernel(label, adv, adv64, dt, rng):
    """One mega stage, kernel vs plain version (`hold`; adv64: the f64
    operator of the same case, for the f64 evaluation), on random u; raises
    beyond the limit. Returns the measured numbers."""
    dtype = adv.dtype
    u, unbr, smin, smax = stage_inputs(adv, rng)
    t, dt = as_dtype(0.1, dtype), as_dtype(dt, dtype)
    args = (t, dt, u, unbr, smin, smax, adv._poly, adv._stage_tables)
    n_cg = ms.default_sweeps(dtype)
    got = ms.mega_stage(*args)
    torch.cuda.synchronize()
    ref = ms.mega_stage_reference(*args, n_cg)
    ref64 = None
    if dtype == torch.float32:
        ref64 = ms.mega_stage_reference(
            t, dt, *f64_inputs(u, unbr, smin, smax, adv._poly),
            adv64._stage_tables, n_cg)
    torch.cuda.synchronize()
    err, rel, prel = hold(label, "du", got, ref, ref64, LIMITS[dtype])
    res = dict(check=label, kernel="mega_stage", E=u.shape[0],
               max_abs_err=err, rel_err=rel, limit=LIMITS[dtype],
               plain_f32_rel_err=prel,
               ms=time_ms(lambda: ms.mega_stage(*args), 20),
               plain_ms=time_ms(
                   lambda: ms.mega_stage_reference(*args, n_cg), 5))
    res.update(bound(*stage_cost(adv._stage_tables, adv._poly, n_cg),
                     dtype))
    print(json.dumps(res), flush=True)
    return res


def sparsity_inputs(adv, u):
    """Per-dof sparsity bounds (-bt 1) of u, contiguous, as the operator
    gives them to kernel 1's per-dof variant."""
    topo = dofmaps.bounds_topology(adv.disc.mesh, adv.disc.p, adv.device)
    return tuple(b.contiguous() for b in bounds.sparsity_bounds(
        *bounds.elements_min_max(u), topo.nbr_elem, topo.nd))


def check_kernel_dof(label, adv, adv64, dt, rng, traced=False):
    """Kernel 1's per-dof variant (bounds "dof") on random u with its
    sparsity bounds: against its plain version (`hold`), and against the
    "T" variant on the same inputs with the class-major stencil expanded to
    dofs (the same function: equal to round-off, LIMITS); raises beyond
    either. Returns the measured numbers."""
    dtype = adv.dtype
    u, unbr, smin, smax = stage_inputs(adv, rng)
    xmin, xmax = sparsity_inputs(adv, u)
    t, dt = as_dtype(0.1, dtype), as_dtype(dt, dtype)
    P, tb = adv._poly, adv._stage_tables
    args = (t, dt, u, unbr, xmin, xmax, P, tb)
    n_cg = ms.default_sweeps(dtype)
    got = ms.mega_stage(*args, bounds="dof")
    torch.cuda.synchronize()
    ref = ms.mega_stage_reference(*args, n_cg, "dof")
    ref64 = None
    if dtype == torch.float32:
        ref64 = ms.mega_stage_reference(
            t, dt, *f64_inputs(u, unbr, xmin, xmax, P),
            adv64._stage_tables, n_cg, "dof")
    torch.cuda.synchronize()
    err, rel, prel = hold(label + " per-dof", "du", got, ref, ref64,
                          LIMITS[dtype])
    cls = tb["cls"].long()
    du_T = ms.mega_stage(t, dt, u, unbr, smin, smax, P, tb)
    du_dof = ms.mega_stage(t, dt, u, unbr, smin[cls].T.contiguous(),
                           smax[cls].T.contiguous(), P, tb, bounds="dof")
    torch.cuda.synchronize()
    err_T, rel_T = compare(label + " per-dof against T", "du", du_dof,
                           du_T, LIMITS[dtype])
    res = dict(check=label, kernel="mega_stage", variant="dof",
               E=u.shape[0], max_abs_err=err, rel_err=rel,
               limit=LIMITS[dtype], plain_f32_rel_err=prel,
               vs_T_max_abs_err=err_T, vs_T_rel_err=rel_T,
               ms=time_ms(lambda: ms.mega_stage(*args, bounds="dof"), 20),
               T_ms=time_ms(lambda: ms.mega_stage(
                   t, dt, u, unbr, smin, smax, P, tb), 20),
               plain_ms=time_ms(
                   lambda: ms.mega_stage_reference(*args, n_cg, "dof"), 5))
    res.update(bound(*stage_cost(tb, P, n_cg, kind="mega_dof"), dtype))
    if traced:
        res["trace_ms"] = traced_ms(
            lambda: ms.mega_stage(*args, bounds="dof"), "mega_stage")
    print(json.dumps(res), flush=True)
    return res


def check_kernel_E(label, adv, adv64, dt, rng, traced=False):
    """Kernel 1's element-major variant (bounds "E", the [E, 3^dim] stencil
    a shard of a sharded grid gives it) on random u: equal to the "T"
    variant bit for bit on the same stencil values (the transpose), and
    against its plain version (`hold`, `stage_limit`); raises otherwise.
    Returns the measured numbers."""
    dtype = adv.dtype
    u, unbr, smin, smax = stage_inputs(adv, rng)
    emin, emax = adv.compute_bounds_stencil(*bounds.elements_min_max(u))
    if not (torch.equal(emin, smin.T) and torch.equal(emax, smax.T)):
        raise RuntimeError(f"{label}: the element-major stencil is not the "
                           "transpose of the class-major one")
    t, dt = as_dtype(0.1, dtype), as_dtype(dt, dtype)
    P, tb = adv._poly, adv._stage_tables
    args = (t, dt, u, unbr, emin, emax, P, tb)
    n_cg = ms.default_sweeps(dtype)
    got = ms.mega_stage(*args, bounds="E")
    du_T = ms.mega_stage(t, dt, u, unbr, smin, smax, P, tb)
    torch.cuda.synchronize()
    if not torch.equal(got, du_T):
        raise RuntimeError(f"{label}: kernel 1's \"E\" variant differs from "
                           f"\"T\" by {float((got - du_T).abs().max()):g}")
    ref = ms.mega_stage_reference(*args, n_cg, "E")
    ref64 = None
    if dtype == torch.float32:
        ref64 = ms.mega_stage_reference(
            t, dt, *f64_inputs(u, unbr, emin, emax, P), adv64._stage_tables,
            n_cg, "E")
    torch.cuda.synchronize()
    lim = stage_limit(adv)
    err, rel, prel = hold(label + " element-major", "du", got, ref, ref64,
                          lim)
    res = dict(check=label, kernel="mega_stage", variant="E", E=u.shape[0],
               p=adv.disc.p, max_abs_err=err, rel_err=rel,
               limit=lim if lim is not None else "plain f32",
               plain_f32_rel_err=prel, vs_T="bit for bit",
               ms=time_ms(lambda: ms.mega_stage(*args, bounds="E"), 20),
               T_ms=time_ms(lambda: ms.mega_stage(
                   t, dt, u, unbr, smin, smax, P, tb), 20),
               plain_ms=time_ms(
                   lambda: ms.mega_stage_reference(*args, n_cg, "E"), 5))
    res.update(bound(*stage_cost(tb, P, n_cg, kind="mega_elem"), dtype))
    if traced:
        res["trace_ms"] = traced_ms(
            lambda: ms.mega_stage(*args, bounds="E"), "mega_stage")
    print(json.dumps(res), flush=True)
    return res


def check_p16(label, adv, adv64, dt, rng, traced=False):
    """Kernels 1 ("T") and 2 (with LO) reading the bf16 va/vn stream P16
    (f32; the operator's own x0 and v through build_poly_tables(...,
    va_vn_bf16=True)) against their P16 plain versions evaluated in f64 on
    the same bf16 values (`hold`, LIMITS; wdet, read from the f32 P alone,
    at WDET_LIMITS in f32); raises beyond them. Returns {kernel: record}."""
    u, unbr, smin, smax = stage_inputs(adv, rng)
    P, P16 = tbl.build_poly_tables(adv.x0_nodes, adv.v_nodes, adv.disc,
                                   va_vn_bf16=True)
    tb, tb64 = adv._stage_tables, adv64._stage_tables
    t, dt = as_dtype(0.1, torch.float32), as_dtype(dt, torch.float32)
    n_cg = ms.default_sweeps(torch.float32)
    u64, unbr64, smin64, smax64, P64 = f64_inputs(u, unbr, smin, smax, P)
    mega = lambda: ms.mega_stage(t, dt, u, unbr, smin, smax, P, tb, P16=P16)
    ho = lambda: sh.stage_ho(t, u, unbr, P, tb, dt=dt, with_lo=True, P16=P16)
    out = {}
    for name, kern, ref32, ref64, cost in (
            ("mega_stage", lambda: (mega(),),
             lambda: (ms.mega_stage_reference(t, dt, u, unbr, smin, smax, P,
                                              tb, n_cg, "T", P16),),
             lambda: (ms.mega_stage_reference(t, dt, u64, unbr64, smin64,
                                              smax64, P64, tb64, n_cg, "T",
                                              P16),),
             stage_cost(tb, P, n_cg, P16=P16)),
            ("stage_ho", ho,
             lambda: sh.stage_ho_poly_reference(t, u, unbr, P, tb, n_cg,
                                                dt=dt, with_lo=True, P16=P16),
             lambda: sh.stage_ho_poly_reference(t, u64, unbr64, P64, tb64,
                                                n_cg, dt=dt, with_lo=True,
                                                P16=P16),
             stage_cost(tb, P, n_cg, "ho", True, P16=P16))):
        got = kern()
        torch.cuda.synchronize()
        refs, refs64 = ref32(), ref64()
        names = ("du", "wdet", "du_LO")[:len(refs)]
        limits = (LIMITS[torch.float32], WDET_LIMITS[torch.float32],
                  LIMITS[torch.float32])
        # wdet in its working type: no mass inverse amplifies its rounding
        errs = {k: hold(f"{label} {name} P16", k, g, r,
                        None if k == "wdet" else r64, lim)
                for k, g, r, r64, lim in zip(names, got, refs, refs64,
                                             limits)}
        rec = dict(check=label, kernel=name, variant="P16", E=u.shape[0],
                   max_abs_err=max(errs[k][0] for k in names if k != "wdet"),
                   rel_err={k: errs[k][1] for k in names},
                   plain_f32_rel_err={k: errs[k][2] for k in names},
                   limit=LIMITS[torch.float32],
                   P_bytes=P.numel() * 4, P16_bytes=P16.numel() * 2,
                   ms=time_ms(kern, 20),
                   plain_ms=time_ms(ref32, 5))
        rec.update(bound(*cost, torch.float32))
        if traced:
            rec["trace_ms"] = traced_ms(kern, name)
        print(json.dumps(rec), flush=True)
        out[name] = rec
    return out


def check_stage_ho(label, adv, adv64, dt, rng, with_lo, n_cg=None,
                   timed=True):
    """One HO stage, kernel vs plain version (`hold`), on random u: du_HO,
    wdet and (with_lo) du_LO; raises beyond the limits."""
    dtype = adv.dtype
    tb, P = adv._stage_tables, adv._poly
    u, unbr, _, _ = stage_inputs(adv, rng)
    n = sh.default_sweeps(dtype) if n_cg is None else n_cg
    t, dt = as_dtype(0.1, dtype), as_dtype(dt, dtype)
    kw = dict(n_cg=n_cg, dt=dt, with_lo=with_lo)
    got = sh.stage_ho(t, u, unbr, P, tb, **kw)
    torch.cuda.synchronize()
    ref = sh.stage_ho_poly_reference(t, u, unbr, P, tb, n, dt=dt,
                                     with_lo=with_lo)
    ref64 = [None] * len(ref)
    if dtype == torch.float32:
        ref64 = sh.stage_ho_poly_reference(
            t, *f64_inputs(u, unbr, P), adv64._stage_tables, n, dt=dt,
            with_lo=with_lo)
    torch.cuda.synchronize()
    names = ("du_HO", "wdet", "du_LO")[:len(ref)]
    limits = (LIMITS[dtype], WDET_LIMITS[dtype], LIMITS[dtype])
    # wdet in its working type: no mass inverse amplifies its rounding
    errs = {k: hold(label, k, g, r, None if k == "wdet" else r64, lim)
            for k, g, r, r64, lim in zip(names, got, ref, ref64, limits)}
    res = dict(check=label, kernel="stage_ho", E=u.shape[0],
               with_lo=with_lo, n_cg=n,
               max_abs_err=max(errs[k][0] for k in names if k != "wdet"),
               rel_err={k: errs[k][1] for k in names},
               plain_f32_rel_err={k: errs[k][2] for k in names},
               limit=LIMITS[dtype], wdet_limit=WDET_LIMITS[dtype])
    if timed:
        res.update(
            ms=time_ms(lambda: sh.stage_ho(t, u, unbr, P, tb, **kw), 20),
            plain_ms=time_ms(lambda: sh.stage_ho_poly_reference(
                t, u, unbr, P, tb, n, dt=dt, with_lo=with_lo), 5))
    res.update(bound(*stage_cost(tb, P, n, "ho", with_lo), dtype))
    print(json.dumps(res), flush=True)
    return res


def check_wdet(label, adv, traced=False):
    """wdet kernel vs plain version (`hold`: in f32 the plain version
    evaluated in f64) at the nodes x0 + 0.3 v; `traced`: also its device
    time from a trace."""
    dtype = adv.dtype
    xs = (adv.x0_nodes + 0.3 * adv.v_nodes).contiguous()
    tb = adv._wdet_tables
    got = wd.wdet(xs, tb)
    torch.cuda.synchronize()
    ref = wd.wdet_reference(xs, tb)
    ref64 = None
    if dtype == torch.float32:
        tb64 = wd.wdet_tables(adv.disc, torch.float64, adv.device)
        ref64 = wd.wdet_reference(*f64_inputs(xs), tb64)
    torch.cuda.synchronize()
    err, rel, prel = hold(label, "wdet", got, ref, ref64, WDET_LIMITS[dtype])
    res = dict(check=label, kernel="wdet", E=xs.shape[0], m1=tb["m1"],
               Q1=tb["Q1"], max_abs_err=err, rel_err=rel,
               plain_f32_rel_err=prel, limit=WDET_LIMITS[dtype],
               ms=time_ms(lambda: wd.wdet(xs, tb), 20),
               plain_ms=time_ms(lambda: wd.wdet_reference(xs, tb), 5))
    if traced:
        res["trace_ms"] = traced_ms(lambda: wd.wdet(xs, tb), "wdet")
    res.update(bound(*wdet_cost(xs, tb), dtype))
    print(json.dumps(res), flush=True)
    return res


def check_wdet_face(label, adv, traced=False):
    """wdet's face variant vs its plain version (`hold`: in f32 the plain
    version evaluated in f64) at the nodes x0 + 0.3 v with the mesh velocity
    of the non-fused operator `adv`: wdet and wvn at the wdet limits, and
    wdet bit for bit the wdet-only variant's; `traced`: also its device time
    from a trace."""
    dtype = adv.dtype
    xs = (adv.x0_nodes + 0.3 * adv.v_nodes).contiguous()
    v, tb = adv.v_nodes, adv._wdet_tables
    got = wd.wdet(xs, tb, v)
    torch.cuda.synchronize()
    ref = wd.wdet_reference(xs, tb, v)
    ref64 = (None, None)
    if dtype == torch.float32:
        tb64 = wd.wdet_tables(adv.disc, torch.float64, adv.device, face=True)
        ref64 = wd.wdet_reference(*f64_inputs(xs), tb64, *f64_inputs(v))
    torch.cuda.synchronize()
    label = f"{label} face"
    errs = {k: hold(label, k, g, r, r64, WDET_LIMITS[dtype])
            for k, g, r, r64 in zip(("wdet", "wvn"), got, ref, ref64)}
    if not torch.equal(got[0], wd.wdet(xs, tb)):
        raise RuntimeError(f"{label}: wdet differs from the wdet-only "
                           "variant's")
    res = dict(check=label, kernel="wdet", variant="face", E=xs.shape[0],
               m1=tb["m1"], Q1=tb["Q1"], max_abs_err=errs["wvn"][0],
               rel_err={k: e[1] for k, e in errs.items()},
               plain_f32_rel_err={k: e[2] for k, e in errs.items()},
               limit=WDET_LIMITS[dtype], wdet_vs_wdet_only="bit for bit",
               ms=time_ms(lambda: wd.wdet(xs, tb, v), 20),
               plain_ms=time_ms(lambda: wd.wdet_reference(xs, tb, v), 5))
    if traced:
        res["trace_ms"] = traced_ms(lambda: wd.wdet(xs, tb, v), "wdet")
    res.update(bound(*wdet_cost(xs, tb, with_face=True), dtype))
    print(json.dumps(res), flush=True)
    return res


def fa_moving_mesh(n, device):
    """The assembled stage kernel's inputs, f64: the tables' discretization
    of an n^3 unit cube (mesh order 2, p = FA_P), its nodes curved, a
    smooth nodal velocity v and the nodes moved to t = FA_T."""
    mesh = make_cartesian_mesh(3, (n,) * 3, (0.0,) * 3, (1.0,) * 3,
                               (False,) * 3)
    disc = build_discretization(mesh, FA_P)
    x = torch.as_tensor(mesh.x, dtype=torch.float64, device=device)
    x0 = x + 0.03 * torch.sin(3.0 * x.flip(-1))
    v = 0.1 * torch.sin(2.0 * np.pi * x.flip(-1))
    return disc, (x0 + FA_T * v).contiguous(), v.contiguous()


def fa_plain(xs, v, tb):
    """fa_assemble's plain chain on the nodes taken relative to each
    element's first node: the element data do not change under a
    translation, and the dense sums of O(1) coordinates cost the plain chain
    ~1.5e-13 of det J's largest entry in f64 at 64^3 (h^3 = 3.8e-6), beside
    the kernel's relative coordinates."""
    return fa.fa_assemble_reference(
        xs - xs[:, :1, :], tb, 1, geo.interp_nodes(v, tb["Bm"]),
        geo.face_velocity(v, tb["Bmf"]))


def check_fa_assemble(n, dtype, disc, xs64, v64):
    """fa_assemble vs its plain chain (`fa_plain`) on the inputs of
    `fa_moving_mesh` (`hold`: in f32 the plain chain evaluated in f64 on
    the same f32 inputs): every output at FA_LIMITS; its ms by CUDA events
    and from a trace of 3 calls, the plain chain's ms as the operator runs
    it (absolute nodes, the mesh velocity at the points made once) and the
    bound."""
    tb = fa.fa_assemble_tables(disc, dtype, xs64.device)
    if not tb["engaged"]:
        raise RuntimeError(f"fa_assemble does not engage at N={n}")
    xs, v = xs64.to(dtype).contiguous(), v64.to(dtype).contiguous()
    prec = "f32" if dtype == torch.float32 else "f64"
    label = f"fa_assemble 3d N={n} p={FA_P} {prec}"
    got = fa.fa_assemble(xs, v, tb)
    ref = fa_plain(xs, v, tb)
    ref64 = [None] * len(FA_OUTPUTS)
    if dtype == torch.float32:
        tb64 = fa.fa_assemble_tables(disc, torch.float64, xs64.device)
        ref64 = fa_plain(*f64_inputs(xs, v), tb64)
    v_pts = (geo.interp_nodes(v, tb["Bm"]), geo.face_velocity(v, tb["Bmf"]))
    torch.cuda.synchronize()
    errs = {k: hold(label, k, g, r, r64, FA_LIMITS[dtype])
            for k, g, r, r64 in zip(FA_OUTPUTS, got, ref, ref64)}
    del got, ref, ref64
    torch.cuda.empty_cache()

    def launch():
        fa.fa_assemble(xs, v, tb)

    res = dict(check=label, kernel="fa_assemble", E=xs.shape[0],
               Q1=tb["Q1"], D=tb["D"],
               max_abs_err=max(e[0] for e in errs.values()),
               rel_err={k: e[1] for k, e in errs.items()},
               plain_f32_rel_err={k: e[2] for k, e in errs.items()},
               limit=FA_LIMITS[dtype], ms=time_ms(launch, 10),
               plain_ms=time_ms(
                   lambda: fa.fa_assemble_reference(xs, tb, 1, *v_pts), 3),
               trace_ms=traced_ms(launch, "fa_assemble", n=3))
    res.update(bound(*fa_assemble_cost(xs, tb), dtype))
    print(json.dumps(res), flush=True)
    return res


def fa_assemble_checks(device):
    """check_fa_assemble at FA_SIZES, f64 and f32: {"<N>_<prec>": record}."""
    out = {}
    for n in FA_SIZES:
        disc, xs64, v64 = fa_moving_mesh(n, device)
        for dtype, prec in ((torch.float64, "f64"), (torch.float32, "f32")):
            out[f"{n}_{prec}"] = check_fa_assemble(n, dtype, disc, xs64, v64)
        del xs64, v64
        torch.cuda.empty_cache()
    return out


def fa_fct_stage(n, device):
    """One limited stage's inputs to fa_fct on path G's configuration at
    p = FA_P on n^3 elements (the assembled cell's), f64, at its CFL dt:
    the element data at t = FA_T, the initial u, du_HO, du_LO and the dof
    bounds. Returns (adv, geom, (u, du_HO, du_LO, u_min, u_max), dt)."""
    cfg = RunConfig(device=str(device), **dict(
        PATH_G, elem_per_shard=n ** 3, order=FA_P, dt=-1.0))
    adv, dt = driver.build_operator(cfg)
    mesh = adv.disc.mesh
    u, _ = driver.project_bernstein(
        adv.x0_nodes, adv.disc.Bm_at_unodes,
        lambda x: prob.u0_function(cfg.problem, x, mesh.bb_min, mesh.bb_max))
    geom = adv.geometry(FA_T)
    du_ho = adv.ho_solution(geom, u)
    du_lo = adv.lo_solution(geom, u, du_HO=du_ho, dt=dt)
    u_min, u_max = adv.compute_bounds(*bounds.elements_min_max(u))
    return adv, geom, (u, du_ho, du_lo, u_min.contiguous(),
                       u_max.contiguous()), dt


def check_fa_fct(n, dtype, adv, geom, vectors, dt):
    """fa_fct against its plain chain (`fa_fct_reference`) on the stage of
    `fa_fct_stage` cast to dtype, one and two sweeps, one launch counted
    each (`hold`: in f32 against the plain chain evaluated in f64 on the
    same f32 inputs); its ms by CUDA events and from a trace of 3 calls,
    the plain chain's ms and the bound, one sweep as the operator runs
    it."""
    prec = "f32" if dtype == torch.float32 else "f64"
    label = f"fa_fct 3d N={n} p={FA_P} {prec}"
    keys = ("K_elem", "M", "bdrInt", "ml")
    g = {k: geom[k].to(dtype).contiguous() for k in keys}
    vec = [x.to(dtype).contiguous() for x in vectors]
    tb, bd = adv.fa_fct_tables, adv.bdr_dofs
    errs = {}
    for iters in (1, 2):
        before = ff.fa_fct.launches
        got = ff.fa_fct(g, *vec, dt, tb, iters)
        if ff.fa_fct.launches != before + 1:
            raise RuntimeError(f"{label}: fa_fct did not count one launch")
        ref = ff.fa_fct_reference(g, *vec, dt, bd, iters)
        ref64, limit = None, FA_FCT_LIMIT
        if dtype == torch.float32:
            ref64 = ff.fa_fct_reference(
                {k: x.to(torch.float64) for k, x in g.items()},
                *f64_inputs(*vec), dt, bd, iters)
            limit = FA_FCT_F32_FACTOR * float(
                (ref.to(torch.float64) - ref64).abs().max()
                / ref64.abs().max())
        torch.cuda.synchronize()
        errs[iters] = (*hold(label, f"du, {iters} sweeps", got, ref, ref64,
                             limit), limit,
                       float((ref - vec[2]).abs().max() / ref.abs().max()))
        del got, ref, ref64
    torch.cuda.empty_cache()

    def launch():
        ff.fa_fct(g, *vec, dt, tb)

    res = dict(check=label, kernel="fa_fct", E=vec[0].shape[0],
               nd=vec[0].shape[1], dt=dt,
               max_abs_err=max(e[0] for e in errs.values()),
               rel_err={f"sweeps_{k}": e[1] for k, e in errs.items()},
               plain_f32_rel_err={f"sweeps_{k}": e[2]
                                  for k, e in errs.items()},
               limit={f"sweeps_{k}": e[3] for k, e in errs.items()},
               flux_share={f"sweeps_{k}": e[4] for k, e in errs.items()},
               ms=time_ms(launch, 10),
               plain_ms=time_ms(
                   lambda: ff.fa_fct_reference(g, *vec, dt, bd), 3),
               trace_ms=traced_ms(launch, "fa_fct", n=3))
    res.update(bound(*fa_fct_cost(vec[0], tb), dtype))
    print(json.dumps(res), flush=True)
    return res


def fa_fct_checks(device):
    """check_fa_fct at FA_SIZES, f64 and f32: {"<N>_<prec>": record}."""
    out = {}
    for n in FA_SIZES:
        adv, geom, vectors, dt = fa_fct_stage(n, device)
        for dtype, prec in ((torch.float64, "f64"), (torch.float32, "f32")):
            out[f"{n}_{prec}"] = check_fa_fct(n, dtype, adv, geom, vectors,
                                              dt)
        del adv, geom, vectors
        torch.cuda.empty_cache()
    return out


def mono_rd_stage(device, cfg, seed):
    """One explicit pass's operands to mono_rd on the `-mono 1 -si`
    operator of `cfg` (f64) from a seeded random u in [0, 1]: (adv, the
    element data, [u, xi_min, xi_max, si_dof, u_nbr])."""
    adv, _ = driver.build_operator(RunConfig(device=str(device), **cfg))
    rng = np.random.default_rng(seed)
    u = torch.as_tensor(rng.random((adv.disc.mesh.num_elements,
                                    adv.disc.nd)), device=device)
    xi_min, xi_max = adv.compute_bounds(*bounds.elements_min_max(u))
    si_dof = adv.smth.dof_values(adv.smth.compute(u))
    geom = adv.geometry(0.0)
    return adv, {k: geom[k] for k in ("K_elem", "bdrInt", "ml")}, [
        u, xi_min.contiguous(), xi_max.contiguous(), si_dof.contiguous(),
        adv.gather_nbr(u, adv.inflow_face)]


def check_mono_rd(dtype, adv, geom, vectors, name, finals):
    """mono_rd against its plain chain (`mono_rd_reference`) on the
    operands of `mono_rd_stage` cast to dtype, for each `final` of
    `finals` (True: the rate, no d_full, as the transport cell runs it;
    False: with d_full, as the inner loop's problems run it), one launch
    counted each (`hold`; in f32 against the plain chain evaluated in f64
    on the same f32 inputs); its ms by CUDA events and from a trace of 3
    calls, the plain chain's ms and the bound, each way."""
    prec = "f32" if dtype == torch.float32 else "f64"
    E = vectors[0].shape[0]
    label = f"mono_rd {name} {prec}"
    g = {k: x.to(dtype).contiguous() for k, x in geom.items()}
    vec = [x.to(dtype).contiguous() for x in vectors]
    tb, bd = adv.mono_rd_tables, adv.bdr_dofs
    res = dict(check=label, kernel="mono_rd", E=E, nd=vec[0].shape[1],
               rel_err={}, plain_f32_rel_err={}, limit={}, ms={},
               trace_ms={}, plain_ms={})
    errs = []
    for final in finals:
        way = "final" if final else "d_full"
        before = mr.mono_rd.launches
        got = mr.mono_rd(g, *vec, tb, final)
        if mr.mono_rd.launches != before + 1:
            raise RuntimeError(f"{label}: mono_rd did not count one launch")
        ref = mr.mono_rd_reference(g, *vec, bd, final)
        ref64 = None
        if dtype == torch.float32:
            ref64 = mr.mono_rd_reference(
                {k: x.to(torch.float64) for k, x in g.items()},
                *f64_inputs(*vec), bd, final)
        torch.cuda.synchronize()
        for name, k in (("du", 0), ("d_full", 1)):
            if ref[k] is None:
                continue
            limit = MONO_RD_LIMIT
            if ref64 is not None:
                limit = FA_FCT_F32_FACTOR * float(
                    (ref[k].to(torch.float64) - ref64[k]).abs().max()
                    / ref64[k].abs().max())
            err = hold(label, f"{name}, {way}", got[k], ref[k],
                       None if ref64 is None else ref64[k], limit)
            errs.append(err[0])
            res["rel_err"][f"{way}_{name}"] = err[1]
            res["plain_f32_rel_err"][f"{way}_{name}"] = err[2]
            res["limit"][f"{way}_{name}"] = limit
        del got, ref, ref64

        def launch():
            mr.mono_rd(g, *vec, tb, final)

        res["ms"][way] = time_ms(launch, 10)
        res["trace_ms"][way] = traced_ms(launch, "mono_rd", n=3)
        res["plain_ms"][way] = time_ms(
            lambda: mr.mono_rd_reference(g, *vec, bd, final), 3)
        res[f"bound_{way}"] = bound(*mono_rd_cost(
            vec[0], tb, vec[3] is not None, final), dtype)
    torch.cuda.empty_cache()
    first = "final" if finals[0] else "d_full"
    res.update(max_abs_err=max(errs), ms_first=res["ms"][first],
               **res[f"bound_{first}"])
    print(json.dumps(res), flush=True)
    return res


def mono_rd_checks(device):
    """check_mono_rd, f64 and f32, on the transport cell's operator (2D p=1,
    -si 2; final, then with d_full) and on path H1's (2D p=2, -si 1; with
    d_full, as it runs): {"<prec>": record, "h1_<prec>": record}."""
    out = {}
    for cfg, key, name, finals, seed in (
            (MONO_RD_CELL, "", "2d 2048^2 p=1 -si 2", (True, False),
             SEED + 9),
            (PATH_H1, "h1_", "path H1 192^2 p=2 -si 1", (False,),
             SEED + 11)):
        adv, geom, vectors = mono_rd_stage(device, cfg, seed)
        for dtype, prec in ((torch.float64, "f64"), (torch.float32, "f32")):
            out[key + prec] = check_mono_rd(dtype, adv, geom, vectors, name,
                                            finals)
        del adv, geom, vectors
        torch.cuda.empty_cache()
    return out


def mono_rd_operands(n, dtype, device):
    """Operands of one mono_rd launch on n^2 p=1 quads of seeded random
    values (the element data need not be a discretization's): ((geom, u,
    xi_min, xi_max, si_dof, u_nbr), tables)."""
    disc = build_discretization(make_cartesian_mesh(
        2, (n, n), (0.0, 0.0), (1.0, 1.0), (False, False)), 1)
    rng = np.random.default_rng(SEED + 10)

    def r(*shape):
        return torch.as_tensor(rng.random((n * n, *shape)), dtype=dtype,
                               device=device)

    u = r(4)
    geom = dict(K_elem=r(4, 4) - 0.5, bdrInt=r(4, 2, 2), ml=r(4) + 0.5)
    return ((geom, u, u - 0.1, u + 0.1, r(4), r(4, 2)),
            mr.mono_rd_tables(disc.dofmaps.bdr_dofs, disc.nd, device))


def nonfused_operator(base):
    """A non-fused operator (-lo 3) on the mesh, nodes and velocity of the
    fused operator `base`: it makes geom_conv's tables."""
    return Advection(base.disc, SolverConfig(problem=10, ho=3, lo=3, fct=2,
                                             pa=True),
                     base.x0_nodes, base.v_nodes, dtype=base.dtype,
                     device=base.device)


def check_geom_conv(label, adv, rng, traced=False):
    """geom_conv kernel vs plain version (`hold`: in f32 the plain version
    evaluated in f64) at the nodes x0 + 0.3 v, the mesh velocity v and a
    random u, with the tables of the non-fused operator `adv`: Ku and wdet,
    then Ku without wdet (`without_wdet`: its own time, plain time and
    bound); `traced`: also the device times from a trace."""
    dtype = adv.dtype
    tb, v = adv._gc_tables, adv.v_nodes
    xs = adv.x0_nodes + 0.3 * v
    u = torch.as_tensor(rng.random((xs.shape[0], adv.disc.nd)), dtype=dtype,
                        device=adv.device)
    got = gc.geom_conv(xs, v, u, tb, 1.0)
    got0 = gc.geom_conv(xs, v, u, tb, 1.0, with_wdet=False)
    torch.cuda.synchronize()
    ref = gc.geom_conv_reference(xs, v, u, tb, 1.0)
    ref64 = (None, None)
    if dtype == torch.float32:
        tb64 = gc.geom_conv_tables(adv.disc, torch.float64, adv.device)
        ref64 = gc.geom_conv_reference(*f64_inputs(xs, v, u), tb64, 1.0)
    torch.cuda.synchronize()
    err, rel, prel = hold(label, "Ku", got[0], ref[0], ref64[0],
                          KU_LIMITS[dtype])
    _, wrel, wprel = hold(label, "wdet", got[1], ref[1], ref64[1],
                          WDET_LIMITS[dtype])
    err0, rel0, _ = hold(label, "Ku without wdet", got0[0], ref[0],
                         ref64[0], KU_LIMITS[dtype])
    if got0[1] is not None:
        raise RuntimeError(f"{label}: geom_conv without wdet returned one")
    kern0 = lambda: gc.geom_conv(xs, v, u, tb, 1.0, with_wdet=False)
    res = dict(check=label, kernel="geom_conv", E=xs.shape[0], m1=tb["m1"],
               Q1=tb["Q1"], max_abs_err=max(err, err0), rel_err=rel,
               rel_err_without_wdet=rel0, wdet_rel_err=wrel,
               plain_f32_rel_err=prel, wdet_plain_f32_rel_err=wprel,
               limit=KU_LIMITS[dtype], wdet_limit=WDET_LIMITS[dtype],
               ms=time_ms(lambda: gc.geom_conv(xs, v, u, tb, 1.0), 20),
               plain_ms=time_ms(
                   lambda: gc.geom_conv_reference(xs, v, u, tb, 1.0), 5))
    res.update(bound(*geom_conv_cost(xs, u, tb), dtype))
    res["without_wdet"] = dict(
        ms=time_ms(kern0, 20),
        plain_ms=time_ms(lambda: gc.geom_conv_reference(
            xs, v, u, tb, 1.0, with_wdet=False), 5),
        **bound(*geom_conv_cost(xs, u, tb, with_wdet=False), dtype))
    if traced:
        res["trace_ms"] = traced_ms(
            lambda: gc.geom_conv(xs, v, u, tb, 1.0), "geom_conv")
        res["without_wdet"]["trace_ms"] = traced_ms(kern0, "geom_conv")
    print(json.dumps(res), flush=True)
    return res


def mesh_order_operator(n, p, mesh_order, dim, dtype, device):
    """A non-fused operator (-lo 3) at order p on the n^dim box of the main
    path, with nodes of the given mesh order moved as the main path's."""
    mesh = make_cartesian_mesh(dim, (n,) * dim, (0.0,) * dim, (1.0,) * dim,
                               (False,) * dim, mesh_order)
    x0 = torch.as_tensor(mesh.x, dtype=torch.float64, device=device)
    v = driver.integrate_mesh_velocity(x0, bench.PROBLEM, mesh.bb_min,
                                       mesh.bb_max, 0.7, 0.2 / STEPS)
    return Advection(build_discretization(mesh, p),
                     SolverConfig(problem=10, ho=3, lo=3, fct=2, pa=True),
                     x0, v, dtype=dtype, device=device)


def check_mesh_orders(dev, rng):
    """wdet and geom_conv at MESH_CASES, 3D N=24 and 2D 16x16, f32 and f64,
    and kernel 5 with its variants at the mesh orders other than 2:
    {kernel: {key: record}}. Kernel 5 draws from its own stream: kernels 3
    and 4 see the inputs they saw before its checks existed."""
    out = {}
    rng5 = np.random.default_rng(SEED + 4)
    for p, mo in MESH_CASES:
        for tag, n, dim in (("3d", N_MAIN, 3), ("2d", 16, 2)):
            size = f"{tag} N={n}" if dim == 3 else f"{tag} {n}x{n}"
            for prec, dtype in (("f32", torch.float32),
                                ("f64", torch.float64)):
                adv = mesh_order_operator(n, p, mo, dim, dtype, dev)
                key = f"p{p}_mo{mo}_{tag}_{prec}"
                label = f"p={p} mesh order {mo} {size} {prec}"
                out.setdefault("wdet", {})[key] = check_wdet(label, adv)
                out.setdefault("geom_conv", {})[key] = check_geom_conv(
                    label, adv, rng)
                if mo != 2:
                    stage_ho_nodes_variants(key, label, adv, rng5, out)
                del adv
        torch.cuda.empty_cache()
    return out


def check_stage_ho_nodes(label, adv, tb, tb64, rng, **kw):
    """Kernel 5 vs plain version (`hold`; tb64: the f64 tables) at the nodes
    x0 + 0.3 v, the mesh velocity v, a random u and its trace: du (Ku with
    n_cg=0) and wdet (in f32 against the plain version evaluated in f64, as
    wdet and geom_conv: the kernel's geometry is theirs); kw are the
    kernel's options (mode, n_cg, with_face)."""
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
    ref64 = (None, None)
    if dtype == torch.float32:
        ref64 = shn.stage_ho_nodes_reference(
            *f64_inputs(xs, v, u, unbr), tb64, **dict(kw, n_cg=n))
    torch.cuda.synchronize()
    err, rel, prel = hold(label, "du", got[0], ref[0], ref64[0],
                          LIMITS[dtype])
    _, wrel, wprel = hold(label, "wdet", got[1], ref[1], ref64[1],
                          WDET_LIMITS[dtype])
    res = dict(check=label, kernel="stage_ho_nodes", E=u.shape[0],
               m1=tb["m1"], mode=kw["mode"], n_cg=n,
               with_face=kw["with_face"], max_abs_err=err, rel_err=rel,
               wdet_rel_err=wrel, plain_f32_rel_err=prel,
               wdet_plain_f32_rel_err=wprel,
               limit=LIMITS[dtype], wdet_limit=WDET_LIMITS[dtype])
    res.update(
        ms=time_ms(lambda: shn.stage_ho_nodes(xs, v, u, unbr, tb, **kw), 20),
        plain_ms=time_ms(lambda: shn.stage_ho_nodes_reference(
            xs, v, u, unbr, tb, **dict(kw, n_cg=n)), 5))
    res.update(bound(*stage_ho_nodes_cost(xs, u, tb, n, kw["with_face"]),
                     dtype))
    print(json.dumps(res), flush=True)
    return res


def check_gl_cg(label, adv, tb, rng, zero_rows=False, n_iter=16):
    """Kernel 6 vs plain version: a random right-hand side and wdet at the
    nodes x0 + 0.3 v (det J varies inside the elements, so the GL mass
    matrix is not diagonal). `zero_rows`: every 7th row of the right-hand
    side is 0 (rr0 = 0: never live); `n_iter`: the iterations (0: x = 0).
    The bound counts the iterations each element takes on this data (from
    the plain version)."""
    dtype = adv.dtype
    xs = (adv.x0_nodes + 0.3 * adv.v_nodes).contiguous()
    wdet = wd.wdet_reference(xs, adv._wdet_tables)
    rhs = torch.as_tensor(rng.standard_normal((xs.shape[0], adv.disc.nd)),
                          dtype=dtype, device=adv.device)
    if zero_rows:
        rhs[::7] = 0.0
    got = cg.gl_cg(rhs, wdet, tb, n_iter=n_iter)
    torch.cuda.synchronize()
    ref, its = cg.gl_cg_reference(rhs, wdet, tb, n_iter=n_iter,
                                  with_iterations=True)
    torch.cuda.synchronize()
    if n_iter == 0 or zero_rows:
        rows = slice(None) if n_iter == 0 else slice(None, None, 7)
        if float(got[rows].abs().max()) != 0.0:
            raise RuntimeError(f"{label}: gl_cg's zero rows are not 0")
    if n_iter == 0:
        err = rel = 0.0
    else:
        err, rel = compare(label, "x", got, ref, LIMITS[dtype])
    res = dict(check=label, kernel="gl_cg", E=rhs.shape[0], n_iter=n_iter,
               zero_rows=zero_rows, max_abs_err=err, rel_err=rel,
               limit=LIMITS[dtype],
               iterations_mean=float(its.double().mean()),
               iterations_max=int(its.max()),
               ms=time_ms(lambda: cg.gl_cg(rhs, wdet, tb, n_iter=n_iter), 20),
               plain_ms=time_ms(lambda: cg.gl_cg_reference(
                   rhs, wdet, tb, n_iter=n_iter), 5))
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
    nbr = adv.disc.dofmaps.nbr_dof_local
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
        lay = gn.GatherLayout(shape, periodic, nbr, dev)
        got = gn.gather_nbr(u, lay)
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
            kern = lambda: gn.gather_nbr(u, lay)
            lib_call = lambda: u_pad.index_select(0, idx)
            # host-bound back-to-back calls: in turns, kernel first
            k_ms, l_ms = [], []
            for _ in range(3):
                k_ms.append(time_ms(kern, 100))
                l_ms.append(time_ms(lib_call, 100))
            res.update(
                ms=float(np.mean(k_ms)), ms_runs=k_ms,
                plain_ms=time_ms(lambda: gn.gather_nbr_reference(
                    u, shape, periodic, nbr), 20),
                library_ms=float(np.mean(l_ms)), library_ms_runs=l_ms,
                trace_ms=traced_ms(kern, "gather_nbr"),
                library_trace_ms=traced_ms(lib_call, None))
            res.update(bound(*gather_nbr_cost(u, idx.reshape(E, -1)), dtype))
    print(json.dumps(res), flush=True)
    return res


def traced_ms(fn, kernel, n=10):
    """Device ms per call of fn from a trace of n calls: the port kernel
    `kernel`'s events, or (kernel None) every device event."""
    fn()
    tr, launches = trc.capture_counted(lambda: [fn() for _ in range(n)])
    trc.check_kernel_events(tr, launches, f"{n} calls")
    rep = trc.loop_report(tr, 1, n)
    if kernel is None:
        return 1e3 * rep["total_s_per_stage"]
    return 1e3 * rep["kernel_s_per_stage_by_name"][kernel]


def f64_inputs(*tensors):
    """The same inputs in f64, for the plain version evaluated in f64."""
    return [x.to(torch.float64) for x in tensors]


def order_checks(label, adv, adv64, dt, rng):
    """Kernels 1, 2 (with LO) and 5 on one operator against their plain
    versions (`hold`). Prints and returns one record per kernel."""
    dtype, f64 = adv.dtype, torch.float64
    n_cg = ms.default_sweeps(dtype)
    tb, P = adv._stage_tables, adv._poly
    tb64 = adv64._stage_tables
    u, unbr, smin, smax = stage_inputs(adv, rng)
    u64, unbr64, smin64, smax64, P64 = f64_inputs(u, unbr, smin, smax, P)
    t, dt_ = as_dtype(0.1, dtype), as_dtype(dt, dtype)
    tbn = shn.stage_ho_nodes_tables(adv.disc, dtype, adv.device)
    tbn64 = shn.stage_ho_nodes_tables(adv.disc, f64, adv.device)
    xs = (adv.x0_nodes + 0.3 * adv.v_nodes).contiguous()
    v = adv.v_nodes
    xs64, v64 = f64_inputs(xs, v)
    lim_du = stage_limit(adv)
    control = None
    if dtype == torch.float32:
        control = lost_sweep_rel(t, u64, unbr64, P64, tb64, n_cg)
    cases = dict(
        mega_stage=(
            lambda: (ms.mega_stage(t, dt_, u, unbr, smin, smax, P, tb),),
            lambda: (ms.mega_stage_reference(t, dt_, u64, unbr64, smin64,
                                             smax64, P64, tb64, n_cg),),
            lambda: (ms.mega_stage_reference(t, dt_, u, unbr, smin, smax, P,
                                             tb, n_cg),),
            stage_cost(tb, P, n_cg)),
        stage_ho=(
            lambda: sh.stage_ho(t, u, unbr, P, tb, dt=dt_, with_lo=True),
            lambda: sh.stage_ho_poly_reference(t, u64, unbr64, P64, tb64,
                                               n_cg, dt=dt_, with_lo=True),
            lambda: sh.stage_ho_poly_reference(t, u, unbr, P, tb, n_cg,
                                               dt=dt_, with_lo=True),
            stage_cost(tb, P, n_cg, "ho", True)),
        stage_ho_nodes=(
            lambda: shn.stage_ho_nodes(xs, v, u, unbr, tbn, mode=1.0),
            lambda: shn.stage_ho_nodes_reference(xs64, v64, u64, unbr64,
                                                 tbn64, mode=1.0, n_cg=n_cg),
            lambda: shn.stage_ho_nodes_reference(xs, v, u, unbr, tbn,
                                                 mode=1.0, n_cg=n_cg),
            stage_ho_nodes_cost(xs, u, tbn, n_cg, True)),
    )
    out = {}
    for name, (kern, ref64, plain, cost) in cases.items():
        got = kern()
        torch.cuda.synchronize()
        ref = plain()
        ref64 = ref64() if dtype == torch.float32 else [None] * len(ref)
        names = ("du", "wdet", "du_LO")[:len(ref)]
        limits = (lim_du, WDET_LIMITS[dtype], LIMITS[dtype])
        # wdet in the working type, but kernel 5's in f32 against the f64
        # evaluation (`check_stage_ho_nodes`)
        errs = {k: hold(f"{label} {name}", k, g, r,
                        None if k == "wdet" and name != "stage_ho_nodes"
                        else r64, lim)
                for k, g, r, r64, lim in zip(names, got, ref, ref64, limits)}
        rec = dict(check=label, kernel=name, E=u.shape[0], n_cg=n_cg,
                   max_abs_err=max(errs[k][0] for k in names if k != "wdet"),
                   rel_err={k: errs[k][1] for k in names},
                   plain_f32_rel_err={k: errs[k][2] for k in names},
                   limit=lim_du if lim_du is not None else "plain f32",
                   lost_sweep_rel=control,
                   ms=time_ms(kern, 20))
        rec.update(bound(*cost, dtype))
        print(json.dumps(rec), flush=True)
        out[name] = rec
    return out


def check_other_orders(dev, rng):
    """order_checks and kernel 6 at ORDERS, 3D N=24 and 2D 16x16, f32 and
    f64, and kernel 1's "E" variant at E_ORDERS: {kernel: {key: record}}
    ("mega_stage_E" for the variant). Kernel 6 and the "E" checks draw from
    streams of their own."""
    out = {}
    rng6 = np.random.default_rng(SEED + 5)
    rng_e = np.random.default_rng(SEED + 7)
    for p in ORDERS:
        for tag, n, dim in (("3d", N_MAIN, 3), ("2d", 16, 2)):
            case = bench.build_case(n, p, torch.float32, dev, n_steps=STEPS,
                                    dim=dim)
            size = f"{tag} N={n}" if dim == 3 else f"{tag} {n}x{n}"
            for prec, adv in (("f32", case.adv), ("f64", case.adv64)):
                label = f"p={p} {size} {prec}"
                recs = order_checks(label, adv, case.adv64, case.dt, rng)
                recs["gl_cg"] = check_gl_cg(label, adv, adv._stage_tables,
                                            rng6)
                if p in E_ORDERS:
                    recs["mega_stage_E"] = check_kernel_E(
                        label, adv, case.adv64, case.dt, rng_e)
                for k, r in recs.items():
                    out.setdefault(k, {})[f"p{p}_{tag}_{prec}"] = r
            del case
            torch.cuda.empty_cache()
    return out


# kernel 5's options beside its defaults (`stage_ho_nodes_variants`)
NODES_VARIANTS = (("n_cg0", dict(n_cg=0)), ("noface", dict(with_face=False)),
                  ("mode-1", dict(mode=-1.0)))
# kernel 6's edge cases beside its defaults (`new_kernel_checks`)
CG_VARIANTS = (("zero_rows", dict(zero_rows=True)), ("n_iter0", dict(n_iter=0)))


def stage_ho_nodes_variants(key, label, adv, rng, out):
    """Kernel 5 on operator `adv` with its defaults and NODES_VARIANTS, into
    out["stage_ho_nodes"][key(_variant)]."""
    tb = shn.stage_ho_nodes_tables(adv.disc, adv.dtype, adv.device)
    tb64 = shn.stage_ho_nodes_tables(adv.disc, torch.float64, adv.device)
    k5 = out.setdefault("stage_ho_nodes", {})
    k5[key] = check_stage_ho_nodes(label, adv, tb, tb64, rng)
    for opt, kw in NODES_VARIANTS:
        k5[f"{key}_{opt}"] = check_stage_ho_nodes(f"{label} {opt}", adv, tb,
                                                  tb64, rng, **kw)


def new_kernel_checks(tag, size, prec, adv, rng, out):
    """Kernels 5-7 against their plain versions on one operator: kernel 5
    with its defaults and NODES_VARIANTS; kernel 6 with its defaults and
    CG_VARIANTS; kernel 7. Results go into out[kernel][key]."""
    key = f"{tag}_{prec}"
    stage_ho_nodes_variants(key, f"{size} {prec}", adv, rng, out)
    tb = adv._stage_tables
    k6 = out.setdefault("gl_cg", {})
    k6[key] = check_gl_cg(f"{size} {prec}", adv, tb, rng)
    for opt, kw in CG_VARIANTS:
        k6[f"{key}_{opt}"] = check_gl_cg(f"{size} {prec} {opt}", adv, tb,
                                         rng, **kw)
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


def fa_launches(attempts, fields):
    """Launches of an assembled remap run with -fct 1: fa_assemble once a
    stage and for each of the two mass reports, fa_fct once a stage."""
    stages = bench.STAGES * attempts
    return dict(fa_assemble=stages + 2, fa_fct=stages)


def fa_sharpen_launches(attempts, fields):
    """Launches of an assembled remap run with another FCT: fa_assemble
    once a stage and for each of the two mass reports."""
    return dict(fa_assemble=bench.STAGES * attempts + 2)


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
               max_u=res.max_u, min_u=res.min_u, u0_min=res.u0_min,
               u0_max=res.u0_max, max_s=res.max_s, launches=n,
               variant_launches=ops.variant_counts(), limits=limits)
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


def mega_launches(attempts, fields):
    """Launches of a mega-stage run: kernel 1 once per stage, wdet for the
    two mass reports."""
    return dict(mega_stage=bench.STAGES * attempts, wdet=2)


def run_path_f(device):
    """Path F: the main path with -bt 1 through driver.run. Every stage is
    one launch of kernel 1's per-dof variant (its variant counter proves
    it); gates on mass, injection and u's range."""
    rec = run_driver_path("F", PATH_F, {k: v for k, v in F_LIMITS.items()
                                        if k != "bounds"},
                          device, mega_launches)
    variants = ops.variant_counts()["mega_stage"]
    want = dict(T=0, E=0, dof=rec["launches"]["mega_stage"], P16=0)
    if variants != want:
        raise RuntimeError(f"F: kernel 1's variants launched {variants}, "
                           f"expected {want}")
    gate("F", "max_u", rec["max_u"], rec["u0_max"] + F_LIMITS["bounds"])
    gate("F", "min_u", rec["min_u"], rec["u0_min"] - F_LIMITS["bounds"],
         least=True)
    rec.update(variant_launches=variants,
               ms_per_stage=rec["ms_per_step"] / bench.STAGES)
    print(json.dumps(dict(path="F", variant_launches=variants,
                          ms_per_stage=rec["ms_per_stage"],
                          MDOF_stages_per_s=rec["MDOF_stages_per_s"])),
          flush=True)
    return rec


def run_path_g(device):
    """Path G: the assembled path at full width in f64, then the sharpening
    configuration; no kernel launches but fa_assemble's and, with -fct 1,
    fa_fct's. Returns the two records."""
    torch.cuda.reset_peak_memory_stats(device)
    rec = run_driver_path("G", PATH_G, G_LIMITS, device, fa_launches)
    rec["max_memory_gib"] = torch.cuda.max_memory_allocated(device) / 2**30
    torch.cuda.empty_cache()
    rec_s = run_driver_path("G sharpen", PATH_G_SHARPEN, G_SHARPEN_LIMITS,
                            device, fa_sharpen_launches)
    print(json.dumps(dict(path="G", max_memory_gib=rec["max_memory_gib"])),
          flush=True)
    return rec, rec_s


def split_fa_stage(device):
    """Where one stage of path G goes, by CUDA events around each part:
    the whole stage; the geometry and assembly (`geometry(t)`: volume and
    face geometry, K_elem, bdrInt, M, ml, the Cholesky factors, D); the HO
    solve (K_HO u, two triangular solves); the LO solution (discrete
    upwind); the bounds; the flux-based FCT. On path G's initial state."""
    cfg = RunConfig(device=str(device), **PATH_G)
    adv, dt = driver.build_operator(cfg)
    mesh = adv.disc.mesh
    u, _ = driver.project_bernstein(
        adv.x0_nodes, adv.disc.Bm_at_unodes,
        lambda x: prob.u0_function(cfg.problem, x, mesh.bb_min, mesh.bb_max))
    t, S = 0.1, u[None]
    stage = adv.stage_function()
    geom = adv.geometry(t)
    du_HO = adv.ho_solution(geom, u)
    du_LO = adv.lo_solution(geom, u, du_HO=du_HO, dt=dt)
    x_min, x_max = adv.compute_bounds(*bounds.elements_min_max(u))
    parts = dict(
        stage=lambda: stage(t, dt, S),
        geometry_assembly=lambda: adv.geometry(t),
        ho_solve=lambda: adv.ho_solution(geom, u),
        lo=lambda: adv.lo_solution(geom, u, du_HO=du_HO, dt=dt),
        bounds=lambda: adv.compute_bounds(*bounds.elements_min_max(u)),
        fct=lambda: adv._fct_solution(geom, u, du_HO, du_LO, x_min, x_max,
                                      dt))
    rec = {"check": "path G stage split, 3d N=%d f64, ms" % N_MAIN}
    rec.update({name: time_ms(fn, 5) for name, fn in parts.items()})
    print(json.dumps(rec), flush=True)
    return rec


def run_fa_goldens(device):
    """The assembled path's golden rows (FA_GOLDEN_ROWS) in f64 on the card
    through the golden runner; no kernel launches but fa_assemble's (the
    remap rows) and fa_fct's (the `-fct 1` rows)."""
    buf = io.StringIO()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = run_goldens.main(["--device", str(device), "--only",
                               *FA_GOLDEN_ROWS])
    n = expect_counts("FA golden rows", {
        k: ops.launch_counts()[k] for k in ("fa_assemble", "fa_fct")})
    for k in ("fa_assemble", "fa_fct"):
        if n[k] == 0:
            raise RuntimeError(f"FA golden rows: {k} never launched")
    lines = buf.getvalue().splitlines()
    for line in lines:
        if line.startswith(("PASS", "FAIL")):
            print(line, flush=True)
    rec = json.loads(lines[-1])
    if rc != 0 or sorted(rec["matched"]) != sorted(FA_GOLDEN_ROWS):
        raise RuntimeError(f"FA golden rows: {rec['matched']} matched, "
                           f"{rec['failed']} failed")
    return dict(matched=rec["matched"], launches=n,
                wall_s=time.perf_counter() - t0)


def run_golden_rows(device, rng, wdet_checks, gc_checks):
    """The cheap remap -pa golden rows of the non-fused path, to the end in
    f64 on the card, against the reference's printed mass and max u. A row
    gives wdet and geom_conv another shape than paths A-D (its own mesh,
    p=2), so both are first held against their plain versions on the row's
    own operator; the checks go into `wdet_checks` and `gc_checks`."""
    rows = golden_rows()
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


# kernel 1's per-dof flag: the fifth template argument (DOF, then BF16)
_PER_DOF = re.compile(
    r"mega_stage_kernel(<[^,()]*, \d+, \d+, \d+, true\b|I.*Lb1ELb[01]EE)")


def trace_each_kernel(case, rng):
    """One launch of each kernel (`ops.KERNELS`), and of kernel 1's per-dof
    variant, at N=24 f32, under the profiler: the trace must hold one
    device event of each (two of kernel 1; the kernels are launched through
    ctypes, outside any aten op). Returns the events and each kernel's
    device ms from the trace ("mega_stage_dof": the per-dof variant, told
    apart by its template flag in the kernel's name): the kernel alone,
    where the CUDA-event times of phase 3 include the wrapper's host work
    whenever that is longer."""
    adv = case.adv
    u, unbr, smin, smax = stage_inputs(adv, rng)
    xmin, xmax = sparsity_inputs(adv, u)
    P, tb = adv._poly, adv._stage_tables
    nf_adv = nonfused_operator(adv)
    tbn = shn.stage_ho_nodes_tables(adv.disc, adv.dtype, adv.device)
    tbf = fa.fa_assemble_tables(adv.disc, adv.dtype, adv.device)
    xs = (adv.x0_nodes + 0.3 * adv.v_nodes).contiguous()
    v = adv.v_nodes
    lay = gn.GatherLayout(adv.shape, adv.periodic,
                          adv.disc.dofmaps.nbr_dof_local, adv.device)
    _, M, ml, K, bdr = fa.fa_assemble(xs, v, tbf)
    fgeom = dict(K_elem=K, M=M, bdrInt=bdr, ml=ml)
    tbc = ff.fa_fct_tables(adv.disc.dofmaps.bdr_dofs, adv.disc.nd,
                           adv.device)
    mono_in, tbm = mono_rd_operands(N_MAIN, adv.dtype, adv.device)

    def each():
        ms.mega_stage(0.1, case.dt, u, unbr, smin, smax, P, tb)
        ms.mega_stage(0.1, case.dt, u, unbr, xmin, xmax, P, tb,
                      bounds="dof")
        sh.stage_ho(0.1, u, unbr, P, tb)
        wdet = wd.wdet(xs, adv._wdet_tables)
        gc.geom_conv(xs, v, u, nf_adv._gc_tables, 1.0)
        shn.stage_ho_nodes(xs, v, u, unbr, tbn, mode=1.0)
        cg.gl_cg(u, wdet, tb)
        gn.gather_nbr(u, lay)
        fa.fa_assemble(xs, v, tbf)
        ff.fa_fct(fgeom, u, u, u, u - 0.1, u + 0.1, case.dt, tbc)
        mr.mono_rd(*mono_in, tbm, True)

    each()                                    # built and warm
    tr, launches = trc.capture_counted(each)
    events = trc.check_kernel_events(tr, launches, "each kernel")
    if events != dict(dict.fromkeys(ops.KERNELS, 1), mega_stage=2):
        raise RuntimeError(f"each kernel: trace events {events}")
    by_name = trc.loop_report(tr, 1, 1)["kernel_s_per_stage_by_name"]
    out = {k: 1e3 * v for k, v in by_name.items()}
    k1 = [o for o in trc.device_ops(tr) if o["kernel"] == "mega_stage"]
    dof = [o for o in k1 if _PER_DOF.search(o["name"])]
    if len(dof) != 1:
        raise RuntimeError("each kernel: the per-dof variant is not one "
                           f"of kernel 1's events {[o['name'] for o in k1]}")
    out["mega_stage_dof"] = 1e-3 * dof[0]["dur"]
    out["mega_stage"] = 1e-3 * sum(o["dur"] for o in k1 if o not in dof)
    return events, out


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
                    "ms_per_stage", "value", "kernel_us_per_stage",
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
    events, tools["trace_ms"] = trace_each_kernel(case, rng)
    print(json.dumps(dict(check="one traced launch of each kernel",
                          trace_kernel_events=events,
                          trace_ms=tools["trace_ms"])), flush=True)
    return main, nonfused, tools


def golden_rows():
    path = Path(__file__).resolve().parent / "goldens" / \
        "reference_goldens.json"
    return {r["name"]: r for r in json.loads(path.read_text())["runs"]}


def run_record(device):
    """Step 9a: the benchmark record at full width, in this process, then
    its sharded loop over a group of one. Returns the unsharded record."""
    recs = []
    for label, env in (("benchmark record", RECORD_ENV),
                       ("sharded benchmark record", SHARDED_RECORD_ENV)):
        ops.reset_launch_counts()
        rec = bench.main(device=device, env=env)
        want = bench.STAGES * int(env["BENCH_STEPS"]) * int(env["BENCH_REPS"])
        problems = []
        if rec["verified"] is not True or not rec["value"] > 0:
            problems.append("not verified")
        if rec["kernels"]["mega_stage"] != want:
            problems.append(f"kernel 1 launched {rec['kernels']['mega_stage']}"
                            f" times over the windows, expected {want}")
        if problems:
            raise RuntimeError(f"{label}: {'; '.join(problems)}")
        recs.append(rec)
    return recs[0]


def run_transport_path(path, cfg_kw, limits, device):
    """Path E: one transport driver.run with its gates; no kernel may
    launch."""
    cfg = RunConfig(device=str(device), **cfg_kw)
    ops.reset_launch_counts()
    res = driver.run(cfg)
    n = expect_counts(path, {})
    mass0 = res.final_mass_u + res.mass_loss_u
    u0_min, u0_max = res.u0_min, res.u0_max
    rec = dict(path=path, dtype=cfg.dtype, ho=cfg.ho, lo=cfg.lo,
               steps=res.steps, dt=res.dt, wall_s=res.timers["wall_s"],
               ms_per_step=1e3 * res.timers["wall_s"] / res.steps,
               mass_loss_u_rel=res.mass_loss_u / abs(mass0),
               closure_injected_rel=res.mass_closure_injected_rel,
               u0_min=u0_min, u0_max=u0_max, min_u=res.min_u,
               max_u=res.max_u, cg_solves=res.cg_solves,
               cg_iterations=res.cg_iterations, launches=n, limits=limits)
    print(json.dumps(rec), flush=True)
    gate(path, "steps", res.steps, cfg.max_tsteps, least=True)
    gate(path, "max_u", res.max_u, u0_max + limits["bounds"])
    gate(path, "min_u", res.min_u, u0_min - limits["bounds"], least=True)
    for name in ("mass_loss_u_rel", "closure_injected_rel"):
        if name in limits:
            gate(path, name, rec[name], limits[name])
    return rec


def run_transport_goldens(device):
    """Step 9c: the transport -pa golden rows through the golden runner (its
    report of the rows the port does not run is left out here)."""
    buf = io.StringIO()
    ops.reset_launch_counts()
    with contextlib.redirect_stdout(buf):
        rc = run_goldens.main(["--device", str(device), "--only",
                               *TRANSPORT_ROWS])
    n = expect_counts("transport golden rows", {})
    lines = buf.getvalue().splitlines()
    for line in lines:
        if line.startswith(("PASS", "FAIL")):
            print(line, flush=True)
    rec = json.loads(lines[-1])
    if rc != 0 or sorted(rec["matched"]) != sorted(TRANSPORT_ROWS):
        raise RuntimeError(f"transport golden rows: {rec['matched']} "
                           f"matched, {rec['failed']} failed")
    return dict(matched=rec["matched"], launches=n)


def run_cli():
    """Step 9d: `python -m remhos_torch` on the card, held against its
    golden row."""
    row = golden_rows()[CLI_ROW]
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", "remhos_torch", *CLI_ARGV],
                         capture_output=True, text=True, timeout=600,
                         cwd=Path(__file__).resolve().parent)
    if out.returncode != 0:
        raise RuntimeError(f"the command line exited {out.returncode}:\n"
                           f"{out.stderr[-3000:]}")
    got = {}
    for line in out.stdout.splitlines():
        for key in ("Final mass u", "Max value u"):
            if line.startswith(key + ":"):
                got[key] = float(line.split(":")[1])
    rec = dict(check="python -m remhos_torch " + " ".join(CLI_ARGV),
               golden=CLI_ROW, wall_s=time.perf_counter() - t0, **got)
    print(json.dumps(rec), flush=True)
    for key, want in (("Final mass u", row["mass"]),
                      ("Max value u", row["max"])):
        v = got.get(key)
        if v is None or not abs(v - want) <= GOLDEN_TOL * abs(want):
            raise RuntimeError(f"the command line: {key} {v} is not the "
                               f"golden {want:.10g}")
    return rec


def expect_no_launch(path):
    """No kernel and no kernel variant launched since the last reset."""
    n = expect_counts(path, {})
    variants = ops.variant_counts()
    if any(v for counts in variants.values() for v in counts.values()):
        raise RuntimeError(f"{path}: kernel variants launched {variants}")
    return n


def run_plain_path(path, cfg_kw, limits, device, launches=None):
    """Paths H and I: one driver.run of a path that launches no kernel (or,
    with `launches`, the kernels `launches(res)` gives, as with -mono 1's
    mono_rd), with its gates (absolute mass loss and max u as the JAX
    package's tests take them; the closure's injection relative to the
    initial mass), its ms per step, its peak device memory and, for -mono,
    the inner loop's iterations and read-backs per stage."""
    cfg = RunConfig(device=str(device), **cfg_kw)
    ops.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats(device)
    res = driver.run(cfg)
    if launches is None:
        n = expect_no_launch(path)
    else:
        n = expect_counts(path, launches(res))
    rec = dict(path=path, dtype=cfg.dtype, mono=cfg.mono,
               smth_ind=cfg.smth_ind, ho=cfg.ho, lo=cfg.lo, fct=cfg.fct,
               elements=load_mesh(cfg.mesh, cfg.rs_levels).num_elements,
               order=cfg.order, steps=res.steps, dt=res.dt,
               wall_s=res.timers["wall_s"],
               ms_per_step=1e3 * res.timers["wall_s"] / res.steps,
               mass_loss_u=res.mass_loss_u,
               mass_loss_u_rel=res.mass_loss_u / abs(res.final_mass_u
                                                      + res.mass_loss_u),
               closure_injected_rel=res.mass_closure_injected_rel,
               max_u=res.max_u, min_u=res.min_u,
               max_memory_gib=torch.cuda.max_memory_allocated(device) / 2**30,
               cg_solves=res.cg_solves, launches=n, limits=limits)
    st = res.mono_stats
    if st:
        stages = bench.STAGES * res.steps
        rec.update(mono_solves=st["solves"],
                   mono_iterations_per_stage_mean=st["iterations"] / stages,
                   mono_iterations_per_stage_max=st["max_iterations"],
                   mono_readbacks_per_stage=st["readbacks"] / stages,
                   mono_check_every=mono.CHECK_EVERY)
    print(json.dumps(rec), flush=True)
    gate(path, "steps", res.steps, cfg.max_tsteps, least=True)
    for name, limit in limits.items():
        gate(path, name, rec[name], limit)
    return rec


def mono_launches(res):
    """Launches of a -mono 1 run on a compiled element: mono_rd once an
    explicit pass."""
    return dict(mono_rd=res.mono_stats["explicit"])


def mono_parts(adv, geom, u, dt):
    """Path H's stage split: the indicator, the solver without its inner
    loop, the inner loop. (Transport: the assembly and the subcell weights
    are made once, at construction.)"""
    parts = mono.explicit_part(adv, geom, u)
    return dict(
        indicator=lambda: adv.smth.dof_values(adv.smth.compute(u)),
        explicit_part=lambda: mono.explicit_part(adv, geom, u),
        inner_loop=lambda: mono.consistent_mass_loop(adv, geom, u, *parts))


def fa_parts(adv, geom, u, dt):
    """Path I's stage split: the HO solve, the LO solution (subcell RD),
    the bounds, ClipScale. (Transport: the assembly and the subcell weights
    are made once, at construction.)"""
    du_HO = adv.ho_solution(geom, u)
    du_LO = adv.lo_solution(geom, u, du_HO=du_HO, dt=dt)
    x_min, x_max = adv.compute_bounds(*bounds.elements_min_max(u))
    return dict(
        ho_solve=lambda: adv.ho_solution(geom, u),
        lo=lambda: adv.lo_solution(geom, u, du_HO=du_HO, dt=dt),
        bounds=lambda: adv.compute_bounds(*bounds.elements_min_max(u)),
        fct=lambda: adv._fct_solution(geom, u, du_HO, du_LO, x_min, x_max,
                                      dt))


def split_plain_stage(device, path, cfg_kw, parts_of):
    """Where one stage of a kernel-free path (H, I) goes, on its initial
    state: the stage and its parts by CUDA events (ms), then one traced
    stage: device ms, device events (launches) per stage, the device's
    idle share and the top ops by device time."""
    cfg = RunConfig(device=str(device), **cfg_kw)
    adv, dt = driver.build_operator(cfg)
    mesh = adv.disc.mesh
    u, _ = driver.project_bernstein(
        adv.x0_nodes, adv.disc.Bm_at_unodes,
        lambda x: prob.u0_function(cfg.problem, x, mesh.bb_min, mesh.bb_max))
    u = u.to(adv.dtype)
    stage = adv.stage_function()
    geom = adv.geometry(0.0)
    rec = {"check": f"path {path} stage split, {cfg.dtype}, ms",
           "stage": time_ms(lambda: stage(0.0, dt, u[None]), 5)}
    rec.update({name: time_ms(fn, 5) for name, fn in
                parts_of(adv, geom, u, dt).items()})
    ops.reset_launch_counts()
    tr = trc.capture_trace(lambda: stage(0.0, dt, u[None]))
    expect_no_launch(f"path {path} traced stage")
    rep = trc.loop_report(tr, 1, 1)
    rec.update(device_ms_per_stage=1e3 * rep["total_s_per_stage"],
               device_events_per_stage=len(trc.device_ops(tr)),
               idle_share=rep["idle_share"],
               top_ops_ms={k: 1e3 * v for k, v in list(
                   rep["buckets_s_per_stage"].items())[:6]})
    print(json.dumps(rec), flush=True)
    return rec


def run_slice10_goldens(device):
    """The tenth slice's golden rows in f64 and transport-ballsjacks-m2 in
    the f32 tier, through the golden runner; no kernel launches but
    mono_rd's in the f64 rows (steady-mono1|2 run -mono 1 at 2D p=1)."""
    out = {}
    for tag, argv, rows in (("f64", [], SLICE10_ROWS),
                            ("f32", ["--f32"], F32_ROWS)):
        buf = io.StringIO()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = run_goldens.main(["--device", str(device), *argv, "--only",
                                   *rows])
        n = ops.launch_counts()
        others = {k: v for k, v in n.items() if k != "mono_rd"}
        variants = ops.variant_counts()
        if (any(others.values()) or (n["mono_rd"] > 0) != (tag == "f64")
                or any(v for c in variants.values() for v in c.values())):
            raise RuntimeError(f"golden rows {tag}: kernel launches {n}, "
                               f"variants {variants}")
        lines = buf.getvalue().splitlines()
        for line in lines:
            if line.startswith(("PASS", "FAIL")):
                print(line, flush=True)
        rec = json.loads(lines[-1])
        if rc != 0 or sorted(rec["matched"]) != sorted(rows):
            raise RuntimeError(f"golden rows {tag}: {rec['matched']} "
                               f"matched, {rec['failed']} failed")
        out[tag] = dict(matched=rec["matched"], launches=n,
                        wall_s=time.perf_counter() - t0)
    print(json.dumps(dict(check="tenth slice golden rows", **out)),
          flush=True)
    return out


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


def cube_rotations():
    """The 24 rotation matrices of the cube (axis permutations with signs,
    det = +1)."""
    rots = []
    for perm in itertools.permutations(range(3)):
        for signs in itertools.product((1, -1), repeat=3):
            R = np.zeros((3, 3))
            for a in range(3):
                R[a, perm[a]] = signs[a]
            if np.linalg.det(R) > 0:
                rots.append(R)
    return rots


def scramble(corners, corner_pos, rng):
    """Each hex's corner frame turned by a random cube rotation
    (tests/test_umesh3d.py's `_scramble`): which old corner sits at each
    new lexicographic position."""
    rots = cube_rotations()
    ref = np.stack([(np.arange(8) >> d) & 1 for d in range(3)], -1) - 0.5
    new_c, new_p = np.empty_like(corners), np.empty_like(corner_pos)
    for e in range(len(corners)):
        R = rots[rng.integers(len(rots))]
        old_of_new = ((ref @ R.T) > 0).astype(int) @ np.array([1, 2, 4])
        new_c[e] = corners[e][old_of_new]
        new_p[e] = corner_pos[e][old_of_new]
    return new_c, new_p


def write_rotated_box(path, rng):
    """The main path's 24^3 box as a general mesh in rotated frames,
    written as an MFEM file; returns the setup seconds."""
    t0 = time.perf_counter()
    box = make_cartesian_mesh(3, (N_MAIN,) * 3, (0.0,) * 3, (1.0,) * 3,
                              (False,) * 3, 2)
    corners, _ = vis._structured_corner_ids(box)
    corner_pos = box.x[:, [0, 2, 6, 8, 18, 20, 24, 26]]
    mesh = umesh3d.from_arrays_3d(*scramble(corners, corner_pos, rng), 2)
    with open(path, "w") as fh:
        fh.write(vis.mfem_mesh_text(mesh, mesh.x))
    return time.perf_counter() - t0


def timed_run(path, cfg_kw, device, launches):
    """One driver.run with its launch counts; returns (result, record):
    ms a step, the setup seconds (the run's wall outside its loop: mesh
    file, tables, operator, mass reports), launches and kernel 1's
    variants."""
    cfg = RunConfig(device=str(device), **cfg_kw)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res = driver.run(cfg)
    total = time.perf_counter() - t0
    n = expect_counts(path, launches(res.steps_total, 1))
    rec = dict(path=path, mesh=cfg.mesh.split("/")[-1], dtype=cfg.dtype,
               ho=cfg.ho, lo=cfg.lo, fct=cfg.fct, steps=res.steps,
               ms_per_step=1e3 * res.timers["wall_s"] / res.steps,
               setup_s=total - res.timers["wall_s"],
               final_mass_u=res.final_mass_u, max_u=res.max_u,
               min_u=res.min_u, u0_min=res.u0_min, u0_max=res.u0_max,
               mass_loss_u_rel=res.mass_loss_u / abs(res.final_mass_u
                                                      + res.mass_loss_u),
               closure_injected_rel=res.mass_closure_injected_rel,
               launches=n, variant_launches=ops.variant_counts()[
                   "mega_stage"])
    print(json.dumps(rec), flush=True)
    gate(path, "steps", res.steps, cfg.max_tsteps, least=True)
    return res, rec


def hold_general(path, rec, ref):
    """A general-mesh run against its structured counterpart (J_LIMITS)."""
    d_mass = abs(rec["final_mass_u"] - ref["final_mass_u"]) / abs(
        ref["final_mass_u"])
    d_max = abs(rec["max_u"] - ref["max_u"])
    gate(path, "final mass against the structured run", d_mass,
         J_LIMITS["mass_rel"])
    gate(path, "max u against the structured run", d_max, J_LIMITS["max_u"])
    return dict(mass_rel_diff=d_mass, max_u_diff=d_max)


def expect_variants(path, rec, T, dof, E=0, P16=0):
    want = dict(T=T, E=E, dof=dof, P16=P16)
    if rec["variant_launches"] != want:
        raise RuntimeError(f"{path}: kernel 1's variants launched "
                           f"{rec['variant_launches']}, expected {want}")


def check_kernel_dof_general(label, adv, adv64, dt, rng):
    """Kernel 1's per-dof variant on a general mesh's own inputs: a random
    u, its gather through the per-element tables and its CG-node overlap
    bounds (the operator's), against the plain version (`hold`)."""
    dtype = adv.dtype
    E, nd = adv._poly.shape[0], adv._stage_tables["nd"]
    u = torch.as_tensor(rng.random((E, nd)), dtype=dtype, device=adv.device)
    unbr = adv.gather_nbr(u).reshape(E, -1)
    xmin, xmax = (b.contiguous() for b in adv.compute_bounds(
        *bounds.elements_min_max(u)))
    t, dt = as_dtype(0.1, dtype), as_dtype(dt, dtype)
    P, tb = adv._poly, adv._stage_tables
    args = (t, dt, u, unbr, xmin, xmax, P, tb)
    n_cg = ms.default_sweeps(dtype)
    got = ms.mega_stage(*args, bounds="dof")
    torch.cuda.synchronize()
    ref = ms.mega_stage_reference(*args, n_cg, "dof")
    ref64 = None
    if dtype == torch.float32:
        ref64 = ms.mega_stage_reference(
            t, dt, *f64_inputs(u, unbr, xmin, xmax, P),
            adv64._stage_tables, n_cg, "dof")
    torch.cuda.synchronize()
    err, rel, prel = hold(label, "du", got, ref, ref64, LIMITS[dtype])
    res = dict(check=label, kernel="mega_stage", variant="dof", E=E,
               max_abs_err=err, rel_err=rel, limit=LIMITS[dtype],
               plain_f32_rel_err=prel,
               ms=time_ms(lambda: ms.mega_stage(*args, bounds="dof"), 20),
               plain_ms=time_ms(
                   lambda: ms.mega_stage_reference(*args, n_cg, "dof"), 5))
    res.update(bound(*stage_cost(tb, P, n_cg, kind="mega_dof"), dtype))
    print(json.dumps(res), flush=True)
    return res


def run_path_j(device, rng):
    """Path J: general meshes at full width (PATH_J1..3). Returns the
    records: the runs, the kernel checks on the rotated mesh's inputs and
    the output checks."""
    out = dict(runs={}, checks={})
    with tempfile.TemporaryDirectory(prefix="remhos_path_j_") as tmp:
        box = str(Path(tmp) / "rotated_box.mesh")
        out["write_s"] = write_rotated_box(box, rng)
        j1 = dict(PATH_J1, mesh=box, rs_levels=0)
        # J1, f64: the rotated box against the structured one
        _, rec = timed_run("J1", j1, device, mega_launches)
        expect_variants("J1", rec, 0, rec["launches"]["mega_stage"])
        _, ref = timed_run("J1 structured", PATH_J1, device, mega_launches)
        expect_variants("J1 structured", ref, ref["launches"]["mega_stage"],
                        0)
        rec.update(hold_general("J1", rec, ref))
        out["runs"].update(J1=rec, J1_structured=ref)
        # J1, f32: the Kahan combine and the full closure, path F's gates
        _, r32 = timed_run("J1 f32", dict(PATH_J1_F32, mesh=box,
                                          rs_levels=0), device,
                           mega_launches)
        expect_variants("J1 f32", r32, 0, r32["launches"]["mega_stage"])
        gate("J1 f32", "mass_loss_u_rel", r32["mass_loss_u_rel"],
             F_LIMITS["mass_loss_u_rel"])
        gate("J1 f32", "closure_injected_rel", r32["closure_injected_rel"],
             F_LIMITS["closure_injected_rel"])
        gate("J1 f32", "max_u", r32["max_u"],
             r32["u0_max"] + F_LIMITS["bounds"])
        gate("J1 f32", "min_u", r32["min_u"],
             r32["u0_min"] - F_LIMITS["bounds"], least=True)
        out["runs"]["J1_f32"] = r32
        # kernel 1's per-dof variant on the rotated mesh's own inputs
        adv64, dt = driver.build_operator(RunConfig(device=str(device),
                                                    **j1))
        adv32, _ = driver.build_operator(RunConfig(
            device=str(device), **dict(j1, dtype="float32")))
        for prec, adv in (("f32", adv32), ("f64", adv64)):
            out["checks"][f"mega_stage_dof_{prec}"] = \
                check_kernel_dof_general(f"J1 rotated 3d N={N_MAIN} {prec}",
                                         adv, adv64, dt, rng)
        del adv32, adv64
        torch.cuda.empty_cache()
        # J2: -ho 2 -lo 4 on the rotated box (kernels 3 and 4)
        j2 = dict(PATH_J2, mesh=box, rs_levels=0)
        _, rec = timed_run("J2", j2, device, nonfused_launches)
        _, ref = timed_run("J2 structured", PATH_J2, device,
                           nonfused_launches)
        rec.update(hold_general("J2", rec, ref))
        out["runs"].update(J2=rec, J2_structured=ref)
        for prec in ("f32", "f64"):
            adv, _ = driver.build_operator(RunConfig(
                device=str(device), **dict(j2, dtype="float" + prec[1:])))
            label = f"J2 rotated 3d N={N_MAIN} {prec}"
            out["checks"][f"wdet_{prec}"] = check_wdet(label, adv)
            out["checks"][f"geom_conv_{prec}"] = check_geom_conv(label, adv,
                                                                 rng)
            del adv
        torch.cuda.empty_cache()
        # J3: 2D, written at -rs 1, read back with the levels left to the
        # registry run's (-rs 4 of -rs 5), with -save
        rs_back = PATH_J3["rs_levels"] - 1
        quad = str(Path(tmp) / "inline_quad_rs1.mesh")
        m = load_mesh("inline-quad", 1)
        with open(quad, "w") as fh:
            fh.write(vis.mfem_mesh_text(m, m.x))
        save_dir = Path(tmp) / "save"
        save_dir.mkdir()
        cwd = Path.cwd()
        os.chdir(save_dir)
        try:
            _, rec = timed_run("J3", dict(PATH_J3, mesh=quad,
                                          rs_levels=rs_back, save=True),
                               device, mega_launches)
        finally:
            os.chdir(cwd)
        expect_variants("J3", rec, 0, rec["launches"]["mega_stage"])
        _, ref = timed_run("J3 registry", PATH_J3, device, mega_launches)
        expect_variants("J3 registry", ref, ref["launches"]["mega_stage"], 0)
        rec.update(hold_general("J3", rec, ref))
        out["runs"].update(J3=rec, J3_registry=ref)
        out["save"] = check_saved(save_dir)
        # -prof: 10 steps of J3 under the profiler
        prof = Path(tmp) / "prof"
        res, rec = timed_run("J3 -prof", dict(PATH_J3, mesh=quad,
                                              rs_levels=rs_back,
                                              max_tsteps=10,
                                              profile_dir=str(prof)),
                             device, mega_launches)
        size = os.path.getsize(res.trace_path)
        with open(res.trace_path) as fh:
            kernels = sum(1 for e in json.load(fh)["traceEvents"]
                          if e.get("cat") == "kernel"
                          and "mega_stage" in e.get("name", ""))
        if not size or Path(res.trace_path).parent != prof:
            raise RuntimeError(f"J3 -prof: no trace in {prof}")
        out["prof"] = dict(trace_bytes=size, mega_stage_kernel_events=kernels,
                           launches=rec["launches"]["mega_stage"])
        print(json.dumps(dict(check="J3 -prof", **out["prof"])), flush=True)
    print(json.dumps(dict(path="J", write_s=out["write_s"],
                          save=out["save"])), flush=True)
    return out


def check_saved(save_dir):
    """J3's -save files: meshHO_final.mesh read back by the general loader
    equals the final nodes of sltn_final.npz (J_SAVE_LIMIT), and
    sltn_final.gf holds E * nd values."""
    with np.load(save_dir / "sltn_final.npz") as z:
        x, u, shape = z["x"], z["u"], z["shape"]
    back = umesh.load_general_mesh(str(save_dir / "meshHO_final.mesh"))
    err = float(np.abs(back.x - x).max())
    gate("J3 -save", "mesh read back against the final nodes", err,
         J_SAVE_LIMIT)
    gf = (save_dir / "sltn_final.gf").read_text()
    n = len(gf.split("Ordering: 0")[1].split())
    if n != u.size or tuple(shape) != (u.shape[0],):
        raise RuntimeError(f"J3 -save: {n} field values, shape {shape}, "
                           f"expected {u.size} and ({u.shape[0]},)")
    return dict(nodes_max_abs_err=err, field_values=n, elements=u.shape[0])


def k_record(path, res, ref, counts=None, variants=None):
    """A sharded run of path K against its unsharded run: printed, gated at
    K_LIMIT (f64) and returned."""
    rec = dict(path=path, shards=res.shards, steps=res.steps,
               ms_per_step=1e3 * res.timers["wall_s"] / res.steps,
               final_mass_u=res.final_mass_u, max_u=res.max_u,
               mass_diff=abs(res.final_mass_u - ref.final_mass_u),
               max_u_diff=abs(res.max_u - ref.max_u),
               unsharded_ms_per_step=1e3 * ref.timers["wall_s"] / ref.steps,
               halo_staged_bytes=res.halo_staged_bytes,
               launches=counts, variant_launches=variants)
    print(json.dumps(rec), flush=True)
    gate(path, "steps", res.steps, ref.steps, least=True)
    return rec


def run_path_k(device):
    """Path K: K1 (one rank, NCCL, in this process; f64 and f32), K2 (4
    ranks sharing the card, gloo, z slabs and a (2, 2) grid) and K3 (5
    ranks, the general route), each against the unsharded run. Returns the
    records by name."""
    out = {}
    dev = str(device)
    ref = driver.run(RunConfig(device=dev, **PATH_K1))
    ops.reset_launch_counts()
    res = driver.run(RunConfig(device=dev, shard_grid=(1,), **PATH_K1))
    want = dict(T=0, E=bench.STAGES * res.steps_total, dof=0, P16=0)
    v = ops.variant_counts()["mega_stage"]
    if v != want:
        raise RuntimeError(f"K1: kernel 1's variants {v}, expected {want}")
    out["K1"] = k_record("K1 f64, 1 rank NCCL", res, ref,
                         ops.launch_counts(), v)
    for k in ("mass_diff", "max_u_diff"):
        gate("K1", k, out["K1"][k], K_LIMIT)
    ref32 = driver.run(RunConfig(device=dev, **PATH_K1_F32))
    ops.reset_launch_counts()
    res32 = driver.run(RunConfig(device=dev, shard_grid=(1,),
                                 **PATH_K1_F32))
    v = ops.variant_counts()["mega_stage"]
    want = dict(T=0, E=bench.STAGES * res32.steps_total, dof=0, P16=0)
    if v != want:
        raise RuntimeError(f"K1 f32: kernel 1's variants {v}, expected "
                           f"{want}")
    rec = k_record("K1 f32, 1 rank NCCL, no closure", res32, ref32,
                   ops.launch_counts(), v)
    m0 = res32.final_mass_u + res32.mass_loss_u
    rec.update(mass_loss_u_rel=res32.mass_loss_u / abs(m0),
               drift_budget=k_drift(res32.steps, PATH_K1_F32["dt"]),
               unsharded_closure_injected_rel=ref32.mass_closure_injected_rel,
               min_u=res32.min_u, u0_min=res32.u0_min, u0_max=res32.u0_max)
    print(json.dumps(dict(path="K1 f32 gates", **{k: rec[k] for k in (
        "mass_loss_u_rel", "drift_budget", "max_u", "min_u")})), flush=True)
    gate("K1 f32", "mass loss", rec["mass_loss_u_rel"], rec["drift_budget"])
    gate("K1 f32", "max u", res32.max_u, res32.u0_max + K_BOUNDS)
    gate("K1 f32", "min u", res32.min_u, res32.u0_min - K_BOUNDS, least=True)
    out["K1 f32"] = rec
    # K2 and K3: one spawn of 5 ranks on the card (gloo, staged)
    ref = driver.run(RunConfig(device=dev, **PATH_K2))
    t0 = time.perf_counter()
    runs = launch.spawn_run(
        [RunConfig(device=dev, shard_grid=g, **PATH_K2) for _, g in K_GRIDS],
        5, dev, timeout_s=600.0, counted=True)
    spawn_s = time.perf_counter() - t0
    for (name, grid), (res, counts, variants) in zip(K_GRIDS, runs):
        n = bench.STAGES * res.steps_total
        want = (dict(T=0, E=n, dof=0, P16=0) if name.startswith("K2")
                else dict(T=0, E=0, dof=n, P16=0))
        if variants["mega_stage"] != want:
            raise RuntimeError(f"{name}: kernel 1's variants on rank 0 "
                               f"{variants['mega_stage']}, expected {want}")
        rec = k_record(f"{name}, grid {grid}, gloo", res, ref, counts,
                       variants["mega_stage"])
        rec["spawn_s_all_three"] = spawn_s
        for k in ("mass_diff", "max_u_diff"):
            gate(name, k, rec[k], K_LIMIT)
        out[name] = rec
    return out


def check_graft_entry():
    """The harness entry `graft_entry.entry()` with no device: its state
    and operator on the card, one RK3 step equal to the CPU step of the
    same state to 1e-12 of max|S| (the assembled path's Cholesky solves
    round differently on the two devices)."""
    from remhos_torch import graft_entry
    fn, args = graft_entry.entry()
    if args[0].device.type != "cuda":
        raise RuntimeError(f"graft entry: state on {args[0].device}")
    out = fn(*args)
    fn_c, args_c = graft_entry.entry("cpu")
    ref = fn_c(*args_c)
    rel = float((out.cpu() - ref).abs().max() / ref.abs().max())
    print(json.dumps(dict(check="graft_entry.entry() on the card",
                          shape=list(out.shape), max_rel_diff_vs_cpu=rel)),
          flush=True)
    gate("graft entry", "max rel diff vs the CPU step", rel, 1e-12)


def run_p16(device, record):
    """The bf16 stream on the main path: the record's f32 leg with
    BENCH_POLY_BF16=1 (verified by the closure's injection budget and the
    2-step f32-vs-f64 cross check), its value beside the headline's from
    this call; then path A with poly_bf16 (kernel 2 on two fields). Every
    kernel-1 launch of the leg and every kernel-2 launch of the path must
    read P16. Returns (the leg's record, path A16's record)."""
    ops.reset_launch_counts()
    rec = bench.main(device=device, env=P16_RECORD_ENV)
    v = ops.variant_counts()["mega_stage"]
    if not (rec["verified"] is True and rec["cross_check"]["status"] == "ran"
            and rec.get("poly_bf16") is True):
        raise RuntimeError(f"P16 record leg not verified: {rec}")
    # the f32 operator's launches read P16: the warm-up and the timed
    # windows and the cross check's 2 f32 steps; the cross check's 2 f64
    # steps take the f64 operator, which has no P16 ("T")
    steps = int(P16_RECORD_ENV["BENCH_STEPS"])
    reps = int(P16_RECORD_ENV["BENCH_REPS"])
    want = bench.STAGES * (steps * (reps + 1) + 2)
    if v != dict(T=want + 2 * bench.STAGES, E=0, dof=0, P16=want):
        raise RuntimeError(f"P16 record leg: variants {v}, expected {want} "
                           "P16 launches")
    rec["variant_launches"] = v
    print(json.dumps(dict(check="P16 record leg", value=rec["value"],
                          headline_value=record["value"],
                          mass_closure_injected_rel=rec[
                              "mass_closure_injected_rel"],
                          f32_vs_f64_2step_rel=rec["f32_vs_f64_2step_rel"],
                          headline_f32_vs_f64_2step_rel=record[
                              "f32_vs_f64_2step_rel"],
                          variant_launches=v)), flush=True)
    a16 = run_driver_path("A P16", PATH_A16, A16_LIMITS, device)
    n16 = sh.stage_ho.variant_launches["P16"]
    if n16 != a16["launches"]["stage_ho"]:
        raise RuntimeError(f"A P16: {n16} P16 launches of kernel 2, "
                           f"expected {a16['launches']['stage_ho']}")
    a16["P16_launches"] = n16
    return rec, a16


def general_rows(path_j, name):
    """A kernel's numbers on path J's rotated mesh, f32 and f64."""
    return {k: {f: path_j["checks"][f"{name}_{k}"][f] for f in (
        "max_abs_err", "rel_err", "ms", "plain_ms", "bound_ms", "bound_by")}
        for k in ("f32", "f64")}


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
    face_checks = {}
    new_checks, dof_checks = {}, {}
    # kernel 1's per-dof variant draws from a stream of its own too, and so
    # do its element-major variant and the P16 checks
    rng_dof = np.random.default_rng(SEED + 4)
    rng_e = np.random.default_rng(SEED + 6)
    rng_16 = np.random.default_rng(SEED + 8)
    e_checks, p16_checks = {}, {}
    for tag, n, dim in (("3d", N_MAIN, 3), ("2d", 16, 2)):
        case = bench.build_case(n, ORDER, torch.float32, dev, n_steps=STEPS,
                                dim=dim)
        size = f"{tag} N={n}" if dim == 3 else f"{tag} {n}x{n}"
        for prec, adv in (("f32", case.adv), ("f64", case.adv64)):
            key = f"{tag}_{prec}"
            checks[key] = check_kernel(f"{size} {prec}", adv, case.adv64,
                                       case.dt, rng)
            dof_checks[key] = check_kernel_dof(f"{size} {prec}", adv,
                                               case.adv64, case.dt, rng_dof,
                                               traced=key == "3d_f32")
            e_checks[key] = check_kernel_E(f"{size} {prec}", adv, case.adv64,
                                           case.dt, rng_e,
                                           traced=key == "3d_f32")
            if prec == "f32":
                p16_checks[tag] = check_p16(f"{size} f32", adv, case.adv64,
                                            case.dt, rng_16,
                                            traced=tag == "3d")
            for with_lo in (True, False):
                k2 = key + ("_lo" if with_lo else "")
                ho_checks[k2] = check_stage_ho(
                    f"{size} {prec} with_lo={with_lo}", adv, case.adv64,
                    case.dt, rng, with_lo)
            main = key == "3d_f32"
            wdet_checks[key] = check_wdet(f"{size} {prec}", adv, main)
            nonfused = nonfused_operator(adv)
            gc_checks[key] = check_geom_conv(f"{size} {prec}", nonfused, rng,
                                             main)
            if dim == 3:
                face_checks[prec] = check_wdet_face(f"{size} {prec}",
                                                    nonfused, main)
            del nonfused
            new_kernel_checks(tag, size, prec, adv, rng_new, new_checks)
        if dim == 3:
            ho_checks["3d_f32_ku"] = check_stage_ho(
                f"{size} f32 n_cg=0 with_lo=True", case.adv, case.adv64,
                case.dt, rng, True, n_cg=0, timed=False)
        del case
        torch.cuda.empty_cache()
    order_recs = check_other_orders(dev, np.random.default_rng(SEED + 2))
    for k, recs in check_mesh_orders(
            dev, np.random.default_rng(SEED + 3)).items():
        order_recs.setdefault(k, {}).update(recs)
    fa_checks = fa_assemble_checks(dev)
    fct_checks = fa_fct_checks(dev)
    mono_checks = mono_rd_checks(dev)
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
    # 6a. path F: -bt 1 on the mega path, kernel 1's per-dof variant
    rec_f = run_path_f(dev)
    torch.cuda.empty_cache()
    done("path F")
    # 7. paths C and D: the non-fused PA stage; 8. its cheap golden rows
    rec_c = run_driver_path("C", PATH_C, C_LIMITS, dev, nonfused_launches)
    rec_path_d = run_driver_path("D", PATH_D, D_LIMITS, dev, nonfused_launches)
    split_nonfused_stage(dev)
    torch.cuda.empty_cache()
    done("paths C and D")
    # 7a. path G: the assembled path at full width, its stage split
    rec_g, _ = run_path_g(dev)
    split_fa_stage(dev)
    torch.cuda.empty_cache()
    done("path G")
    # 8. the measurement entry points: phases, traces, the tools
    _, _, tools = measurement_phase(dev, rng_new)
    torch.cuda.empty_cache()
    done("measurement")
    # 9. the cheap golden rows of the non-fused stage
    run_golden_rows(dev, rng, wdet_checks, gc_checks)
    done("golden rows")
    # 9'. the assembled path's golden rows
    fa_goldens = run_fa_goldens(dev)
    print(json.dumps(dict(check="FA golden rows", **fa_goldens)), flush=True)
    done("FA golden rows")
    # 9a. the benchmark record
    record = run_record(dev)
    torch.cuda.empty_cache()
    done("record")
    # 9b. path E: transport at full width, f32; then -ho 2 -lo 4 in f64
    run_transport_path("E", PATH_E, E_LIMITS, dev)
    run_transport_path("E f64 -ho 2 -lo 4", PATH_E64, E64_LIMITS, dev)
    torch.cuda.empty_cache()
    done("path E")
    # 9c. the transport golden rows; 9d. the command line
    run_transport_goldens(dev)
    run_cli()
    done("transport golden rows and the command line")
    # 9e. path H: -mono 2 -si 2, then -mono 1 -si 1, at 192^2, f64
    run_plain_path("H", PATH_H, H_LIMITS, dev)
    rec_h1 = run_plain_path("H -mono 1 -si 1", PATH_H1, H_LIMITS, dev,
                            mono_launches)
    split_plain_stage(dev, "H", PATH_H, mono_parts)
    torch.cuda.empty_cache()
    done("path H")
    # 9f. path I: 1D, f64 then f32
    run_plain_path("I", PATH_I, I_LIMITS, dev)
    run_plain_path("I f32", PATH_I32, I32_LIMITS, dev)
    split_plain_stage(dev, "I", PATH_I, fa_parts)
    done("path I")
    # 9g. the tenth slice's golden rows, and the repaired f32 -lo 4 row
    run_slice10_goldens(dev)
    done("tenth slice golden rows")
    # 9h. path J: general meshes (rotated 24^3 hexes, refined quads), the
    # output files and the profiler
    path_j = run_path_j(dev, np.random.default_rng(SEED + 5))
    torch.cuda.empty_cache()
    done("path J")
    # 9i. path K: sharded runs (1 rank NCCL; 4 and 5 ranks sharing the card)
    path_k = run_path_k(dev)
    check_graft_entry()
    torch.cuda.empty_cache()
    done("path K")
    # 9j. the bf16 P16 stream: the record's f32 leg, path A with poly_bf16
    p16_rec, path_a16 = run_p16(dev, record)
    torch.cuda.empty_cache()
    done("P16")
    print(json.dumps({"seconds": seconds,
                      "trace_retakes": trc.capture_counted.retakes}),
          flush=True)

    # 10. every ported kernel: `launches` on its own path (mega stage: the
    # main path; stage_ho: path A; wdet and geom_conv: path C; kernels 5-7:
    # the tools, microbench and kernelbench), numbers at 3D N=24 f32
    def row(name, source, replaces, launches, c32, c64, all_checks, **more):
        keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")
        lib = more.pop("library_ms", None)
        more["trace_ms"] = tools["trace_ms"][name]
        if name in order_recs:
            recs = order_recs[name]
            all_checks = dict(all_checks, **recs)
            more["orders"] = {k: {f: r[f] for f in (
                "max_abs_err", "rel_err", "ms", "plain_ms", "bound_ms",
                "bound_by", "without_wdet") if f in r}
                for k, r in recs.items()}
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
            checks, ms=kernel_ms,
            launches_record_windows=record["kernels"]["mega_stage"]),
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
            check_trace_ms=wdet_checks["3d_f32"]["trace_ms"],
            launches_main_path=main_counts["wdet"],
            launches_path_a=rec_a["launches"]["wdet"],
            launches_path_d=rec_path_d["launches"]["wdet"],
            launches_path_j2=path_j["runs"]["J2"]["launches"]["wdet"],
            general_mesh=general_rows(path_j, "wdet")),
        row("geom_conv", "remhos_torch/ops/csrc/geom_conv.cu", pk + ":110",
            rec_c["launches"]["geom_conv"], gc_checks["3d_f32"],
            gc_checks["3d_f64"], gc_checks,
            check_trace_ms=gc_checks["3d_f32"]["trace_ms"],
            without_wdet=gc_checks["3d_f32"]["without_wdet"],
            without_wdet_f64=gc_checks["3d_f64"]["without_wdet"],
            launches_path_d=rec_path_d["launches"]["geom_conv"],
            launches_path_j2=path_j["runs"]["J2"]["launches"]["geom_conv"],
            general_mesh=general_rows(path_j, "geom_conv")),
    ]
    d32, d64 = dof_checks["3d_f32"], dof_checks["3d_f64"]
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")
    kernels.insert(1, dict(
        name="mega_stage_dof", variant_of="mega_stage",
        bounds="per dof [E, nd] (-bt 1; the JAX kernel's "
               "bounds_stencil=False)",
        route="cuda", source="remhos_torch/ops/csrc/mega_stage.cu",
        replaces=pk + ":889", launches=rec_f["launches"]["mega_stage"],
        max_abs_err=d32["max_abs_err"], ms=d32["ms"],
        plain_ms=d32["plain_ms"], bound_ms=d32["bound_ms"],
        bound_by=d32["bound_by"], library_ms=None,
        f64={k: d64[k] for k in keys},
        T_ms=d32["T_ms"], f64_T_ms=d64["T_ms"],
        trace_ms=tools["trace_ms"]["mega_stage_dof"],
        check_trace_ms=d32["trace_ms"],
        launches_path_j1=path_j["runs"]["J1"]["launches"]["mega_stage"],
        launches_path_j3=path_j["runs"]["J3"]["launches"]["mega_stage"],
        general_mesh={k: {f: path_j["checks"][f"mega_stage_dof_{k}"][f]
                          for f in keys}
                      for k in ("f32", "f64")},
        checks=[{k: c[k] for k in ("check", "max_abs_err", "rel_err",
                                   "limit", "vs_T_max_abs_err")}
                for c in dof_checks.values()]))
    e32, e64 = e_checks["3d_f32"], e_checks["3d_f64"]
    e_all = dict(e_checks, **order_recs.get("mega_stage_E", {}))
    kernels.insert(2, dict(
        name="mega_stage_E", variant_of="mega_stage",
        bounds="element-major [E, 3^dim] (a shard of a sharded grid; the "
               "JAX kernel's bounds_stencil=True)",
        route="cuda", source="remhos_torch/ops/csrc/mega_stage.cu",
        replaces=pk + ":889", launches=path_k["K1 f32"]["variant_launches"][
            "E"], max_abs_err=e32["max_abs_err"], ms=e32["ms"],
        plain_ms=e32["plain_ms"], bound_ms=e32["bound_ms"],
        bound_by=e32["bound_by"], library_ms=None,
        f64={k: e64[k] for k in keys}, T_ms=e32["T_ms"],
        f64_T_ms=e64["T_ms"], vs_T="bit for bit", trace_ms=e32["trace_ms"],
        launches_path_k1_f64=path_k["K1"]["variant_launches"]["E"],
        launches_path_k2_rank0={k: path_k[k]["variant_launches"]["E"]
                                for k in ("K2 z", "K2 (2, 2)")},
        orders={k: {f: r[f] for f in keys} for k, r in order_recs.get(
            "mega_stage_E", {}).items()},
        checks=[{k: c[k] for k in ("check", "max_abs_err", "rel_err",
                                   "limit")} for c in e_all.values()]))
    m16, h16 = p16_checks["3d"]["mega_stage"], p16_checks["3d"]["stage_ho"]
    kernels.insert(3, dict(
        name="mega_stage_P16", variant_of="mega_stage",
        stream="va and vn in bf16 (P16), w_q det J in f32 (the JAX "
               "package's poly_bf16), class-major bounds",
        route="cuda", source="remhos_torch/ops/csrc/mega_stage.cu + "
                             "stage_core.cuh",
        replaces=pk + ":889", launches=p16_rec["variant_launches"]["P16"],
        max_abs_err=m16["max_abs_err"], ms=m16["ms"],
        plain_ms=m16["plain_ms"], bound_ms=m16["bound_ms"],
        bound_by=m16["bound_by"], library_ms=None, trace_ms=m16["trace_ms"],
        record_value=p16_rec["value"], headline_value=record["value"],
        checks=[{k: c["mega_stage"][k] for k in ("check", "max_abs_err",
                                                 "rel_err", "limit")}
                for c in p16_checks.values()]))
    k5, k6, k7 = (new_checks[k] for k in ("stage_ho_nodes", "gl_cg",
                                          "gather_nbr"))
    tl = tools["launches"]
    kernels += [
        row("stage_ho_nodes", "remhos_torch/ops/csrc/stage_ho_nodes.cu",
            pk + ":490", tl["stage_ho_nodes"], k5["3d_f32"], k5["3d_f64"], k5,
            options_ms={o: {p: k5[f"3d_{p}_{o}"]["ms"] for p in ("f32", "f64")}
                        for o, _ in NODES_VARIANTS},
            microbench_ms=tools["microbench"]["fused"],
            kernelbench_ms=tools["kernelbench"]),
        row("gl_cg", "remhos_torch/ops/csrc/gl_cg.cu", pk + ":209",
            tl["gl_cg"], k6["3d_f32"], k6["3d_f64"], k6,
            iterations_mean=k6["3d_f32"]["iterations_mean"],
            options_ms={o: {p: k6[f"3d_{p}_{o}"]["ms"] for p in ("f32", "f64")}
                        for o, _ in CG_VARIANTS},
            microbench_ms=tools["microbench"]["gl_cg kernel"],
            microbench_mass_solve_gl_ms=tools["microbench"]["mass_solve_gl"]),
        row("gather_nbr", "remhos_torch/ops/csrc/gather_nbr.cu",
            pk + ":1280", tl["gather_nbr"], k7["3d_f32"], k7["3d_f64"], k7,
            library_ms=k7["3d_f32"]["library_ms"],
            library="index_select of u with a zero slot over a flat index "
                    "table",
            ms_runs=k7["3d_f32"]["ms_runs"],
            library_ms_runs=k7["3d_f32"]["library_ms_runs"],
            check_trace_ms=k7["3d_f32"]["trace_ms"],
            library_trace_ms=k7["3d_f32"]["library_trace_ms"],
            microbench_ms=tools["microbench"]["gather kernel"]),
    ]
    kernels.insert(5, dict(
        name="stage_ho_P16", variant_of="stage_ho",
        stream="va and vn in bf16 (P16), w_q det J in f32",
        route="cuda", source="remhos_torch/ops/csrc/stage_ho.cu + "
                             "stage_core.cuh",
        replaces=pk + ":809", launches=path_a16["P16_launches"],
        max_abs_err=h16["max_abs_err"], ms=h16["ms"],
        plain_ms=h16["plain_ms"], bound_ms=h16["bound_ms"],
        bound_by=h16["bound_by"], library_ms=None, trace_ms=h16["trace_ms"],
        checks=[{k: c["stage_ho"][k] for k in ("check", "max_abs_err",
                                               "rel_err", "limit")}
                for c in p16_checks.values()]))
    f32, f64 = face_checks["f32"], face_checks["f64"]
    kernels.insert(1 + [k["name"] for k in kernels].index("wdet"), dict(
        name="wdet_face", variant_of="wdet",
        outputs="wdet and the non-fused stage's upwind face weights wvn",
        route="cuda", source="remhos_torch/ops/csrc/wdet.cu + mesh_geom.cuh",
        replaces="the face chain of remhos_tpu/operator.py:246-253",
        launches=rec_c["variant_launches"]["wdet"]["face"],
        max_abs_err=f32["max_abs_err"], ms=f32["ms"],
        plain_ms=f32["plain_ms"], bound_ms=f32["bound_ms"],
        bound_by=f32["bound_by"], library_ms=None,
        trace_ms=f32["trace_ms"],
        f64={k: f64[k] for k in ("max_abs_err", "ms", "plain_ms",
                                 "bound_ms", "bound_by")},
        checks=[{k: c[k] for k in ("check", "max_abs_err", "rel_err",
                                   "limit")} for c in face_checks.values()]))
    kernels.append(row(
        "fa_assemble", "remhos_torch/ops/csrc/fa_assemble.cu + mesh_geom.cuh",
        "none: the assembled stage's element assembly in XLA ops "
        "(remhos_tpu/operator.py:270-319)", rec_g["launches"]["fa_assemble"],
        fa_checks["24_f32"], fa_checks["24_f64"], fa_checks,
        check_trace_ms=fa_checks["24_f32"]["trace_ms"],
        at_64={k: {f: fa_checks[f"64_{k}"][f] for f in (
            "max_abs_err", "ms", "trace_ms", "plain_ms", "bound_ms",
            "bound_by")} for k in ("f32", "f64")}))
    kernels.append(row(
        "fa_fct", "remhos_torch/ops/csrc/fa_fct.cu",
        "none: the assembled stage's flux-based FCT in XLA ops "
        "(remhos_tpu/fct_flux.py:39-78)", rec_g["launches"]["fa_fct"],
        fct_checks["24_f32"], fct_checks["24_f64"], fct_checks,
        check_trace_ms=fct_checks["24_f32"]["trace_ms"],
        at_64={k: {f: fct_checks[f"64_{k}"][f] for f in (
            "max_abs_err", "ms", "trace_ms", "plain_ms", "bound_ms",
            "bound_by")} for k in ("f32", "f64")}))
    kernels.append(row(
        "mono_rd", "remhos_torch/ops/csrc/mono_rd.cu",
        "none: the monolithic solver's explicit part in XLA ops "
        "(remhos_tpu/mono.py)", rec_h1["launches"]["mono_rd"],
        mono_checks["f32"], mono_checks["f64"], mono_checks,
        ms=mono_checks["f32"]["ms_first"],
        check_trace_ms=mono_checks["f32"]["trace_ms"],
        d_full={k: {f: mono_checks[k][f]["d_full"] for f in (
            "ms", "trace_ms", "plain_ms")} for k in ("f32", "f64")},
        launches_of="path H1 (192^2 p=2 -si 1, with d_full), checked "
                    "under path_h1; the other fields: the cell's 2048^2 p=1",
        path_h1={k: {f: mono_checks["h1_" + k][f] for f in (
            "max_abs_err", "rel_err", "limit", "ms", "trace_ms", "plain_ms",
            "bound_ms", "bound_by")} for k in ("f32", "f64")}))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
