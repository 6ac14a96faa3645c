"""Command line mirroring the reference's OptionsParser flags
(remhos.cpp:249-334), the port of `remhos_tpu.cli`:

    python -m remhos_torch -m periodic-square -p 5 -rs 3 -dt 0.004 -tf 0.8 \\
        -ho 2 -lo 3 -fct 2 -pa

The run is on the card unless `-d cpu` asks for the plain PyTorch versions
of the kernels on the CPU. `-m` takes a registry mesh name or any MFEM mesh
file (quads, hexes, curved H1 and NURBS). The output lines are the
driver's (Final mass u / Max value u / Mass loss u, remhos.cpp:1423-1436),
so grep-based golden flows (autotest/test.sh) work unchanged. `-save`,
`-visit`, `-vis` and `-prof DIR` write the reference's output files, stream
to GLVis and record a profiler trace of the time loop. That Chrome trace
carries the program's `remhos.*` spans (step, stage, closure, geometry,
gather, bounds, ho > cg, lo, fct, product, and `remhos.sync` at each wait
for the device) on the clock of the device events; a layer's self time is
its span less its child spans (`utils.trace.device_by_span`,
`idle_by_span`, `loop_report`). `-shards n` runs the run sharded over
n ranks: under `torchrun` (or any initialized process group) it joins that
group; otherwise it starts the ranks itself (`parallel.launch.spawn_run`:
gloo processes on the CPU, NCCL with one rank per card, gloo with the ranks
sharing cuda:0 where there are more ranks than cards). `-dcn` is accepted
and changes nothing (a process group has no slice index).
"""

from __future__ import annotations

import argparse

from .config import RunConfig


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="remhos_torch",
        description="Remhos on PyTorch and CUDA: monotonic DG advection "
                    "remap")
    a = p.add_argument
    a("-m", "--mesh", default="default")
    a("-dim", "--dimension", type=int, default=3, dest="dim")
    a("-epm", "--elem-per-shard", type=int, default=1, dest="elem_per_shard")
    a("-p", "--problem", type=int, default=4)
    a("-rs", "--refine-serial", type=int, default=2, dest="rs_levels")
    a("-rp", "--refine-parallel", type=int, default=0, dest="rp_levels")
    a("-o", "--order", type=int, default=3)
    a("-mo", "--mesh-order", type=int, default=2, dest="mesh_order")
    a("-s", "--ode-solver", type=int, default=3, dest="ode_solver")
    a("-ho", "--ho-type", type=int, default=3, dest="ho")
    a("-lo", "--lo-type", type=int, default=0, dest="lo")
    a("-fct", "--fct-type", type=int, default=0, dest="fct")
    a("-mono", "--mono-type", type=int, default=0, dest="mono")
    a("-bt", "--bounds-type", type=int, default=0, dest="bounds_type")
    a("-pa", "--partial-assembly", action="store_true", dest="pa")
    a("-no-pa", "--no-partial-assembly", action="store_false", dest="pa")
    a("-si", "--smth_ind", type=int, default=0, dest="smth_ind")
    a("-tf", "--t-final", type=float, default=4.0, dest="t_final")
    a("-dtc", "--dt-control", type=int, default=0, dest="dt_control")
    a("-dt", "--time-step", type=float, default=0.005, dest="dt")
    a("-ms", "--max-steps", type=int, default=-1, dest="max_tsteps")
    a("-ps", "--product-sync", action="store_true", dest="product_sync")
    a("-no-ps", "--no-product-sync", action="store_false", dest="product_sync")
    a("-vs", "--visualization-steps", type=int, default=100, dest="vis_steps")
    a("-vb", "--verify-bounds", action="store_true", dest="verify_bounds")
    a("-no-vb", "--no-verify-bounds", action="store_false",
      dest="verify_bounds")
    a("-um", "--use-masks", action="store_true", dest="use_masks",
      help="IDP stage masks for product remap (RKIDPSolver::UseMask; the "
           "reference driver runs with masks off, remhos.cpp:502-506)")
    a("-vis", "--visualization", action="store_true", dest="vis")
    a("-no-vis", "--no-visualization", action="store_false", dest="vis")
    a("-save", "--save-meshes-and-solution", action="store_true", dest="save")
    a("-shards", "--n-shards", type=int, default=1, dest="n_shards")
    a("-dcn", "--dcn-outer-axis", action="store_true", dest="dcn")
    a("-d", "--device", default="default",
      help="torch device: default (the card) | cpu | cuda")
    a("-fp32", "--float32", action="store_true", dest="fp32")
    a("-prof", "--profile-dir", default="", dest="profile_dir")
    a("-chk", "--checkpoint-path", default="", dest="checkpoint_path",
      help="checkpoint file (.npz)")
    a("-chks", "--checkpoint-steps", type=int, default=0,
      dest="checkpoint_steps")
    a("-resume", "--resume", action="store_true", dest="resume")
    a("-visit", "--visit-datafiles", action="store_true", dest="visit")
    a("-no-visit", "--no-visit-datafiles", action="store_false", dest="visit")
    p.set_defaults(pa=False, product_sync=False, verify_bounds=False,
                   vis=False, fp32=False, save=False, resume=False,
                   visit=False, use_masks=False)
    return p


def config_from_args(args) -> RunConfig:
    """The RunConfig of parsed arguments."""
    return RunConfig(
        mesh=args.mesh, dim=args.dim, elem_per_shard=args.elem_per_shard,
        problem=args.problem, rs_levels=args.rs_levels,
        rp_levels=args.rp_levels, order=args.order,
        mesh_order=args.mesh_order, ode_solver=args.ode_solver,
        ho=args.ho, lo=args.lo, fct=args.fct, mono=args.mono,
        bounds_type=args.bounds_type, pa=args.pa, smth_ind=args.smth_ind,
        t_final=args.t_final, dt_control=args.dt_control, dt=args.dt,
        max_tsteps=args.max_tsteps, product_sync=args.product_sync,
        vis_steps=args.vis_steps, vis=args.vis,
        profile_dir=args.profile_dir,
        verify_bounds=args.verify_bounds, use_masks=args.use_masks,
        n_shards=args.n_shards, dcn=args.dcn,
        checkpoint_path=args.checkpoint_path,
        checkpoint_steps=args.checkpoint_steps, resume=args.resume,
        save=args.save, visit=args.visit,
        dtype="float32" if args.fp32 else "float64",
        device=None if args.device == "default" else args.device)


def main(argv=None) -> int:
    """Run the configuration of argv. Started by torchrun (its RANK and
    WORLD_SIZE in the environment) with no process group yet, it joins the
    group torchrun gives (`init_method="env://"`) for the run."""
    import os

    import torch.distributed as dist

    from .driver import run
    from .parallel import launch
    cfg = config_from_args(build_parser().parse_args(argv))
    if "WORLD_SIZE" in os.environ and "RANK" in os.environ and \
            not dist.is_initialized():
        launch.init_from_env(cfg.device)
        try:
            run(cfg)
        finally:
            dist.destroy_process_group()
        return 0
    run(cfg)
    return 0
