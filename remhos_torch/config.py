"""Run configuration mirroring the reference CLI flags (remhos.cpp:249-334).

The port's copy of `remhos_tpu.config`. Field names match the reference
long-option spellings so runbooks transfer. Two differences: `device` names
the torch device (None means CUDA, and raises without one), and there is no
`use_pallas`: the port has one implementation of each path. Options whose
code is not ported yet keep their fields; `driver.run` raises
NotImplementedError for them.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class RunConfig:
    mesh: str = "default"            # -m
    dim: int = 3                     # -dim (for -m default)
    elem_per_shard: int = 1          # -epm (elements per device)
    problem: int = 4                 # -p
    rs_levels: int = 2               # -rs
    rp_levels: int = 0               # -rp (folded into rs)
    order: int = 3                   # -o
    mesh_order: int = 2              # -mo
    ode_solver: int = 3              # -s
    ho: int = 3                      # -ho
    lo: int = 0                      # -lo
    fct: int = 0                     # -fct
    mono: int = 0                    # -mono
    bounds_type: int = 0             # -bt
    pa: bool = False                 # -pa (the matrix-free kernel path)
    smth_ind: int = 0                # -si
    t_final: float = 4.0             # -tf
    dt_control: int = 0              # -dtc
    dt: float = 0.005                # -dt
    max_tsteps: int = -1             # -ms
    verify_bounds: bool = False      # -vb
    use_masks: bool = False          # -um: IDP stage masks (UseMask)
    product_sync: bool = False       # -ps
    vis_steps: int = 100             # -vs
    n_shards: int = 1                # sharding over several devices
    shard_grid: tuple = None
    dcn: bool = False
    checkpoint_path: str = ""
    checkpoint_steps: int = 0
    resume: bool = False
    save: bool = False               # -save: write final mesh+solution
    visit: bool = False              # -visit: periodic solution snapshots
    visit_prefix: str = "remhos"
    vis: bool = False                # -vis: GLVis live socket streaming
    vis_host: str = "localhost"
    vis_port: int = 19916
    profile_dir: str = ""            # -prof: a profiler trace of the loop
    dtype: str = "float64"
    closure: bool = True             # f32 conservative mass closure: Kahan-
                                     # compensated RK combine + per-step pin
                                     # of <ml(t), u+c> to the t=0 invariant
                                     # (standard RK; no-op in f64)
    device: str = None               # torch device; None means CUDA
    verbose: bool = True


@dataclasses.dataclass
class RunResult:
    final_mass_u: float
    max_u: float
    mass_loss_u: float
    steps: int
    steps_total: int
    t: float
    dt: float
    final_mass_us: float = 0.0
    max_s: float = 0.0
    mass_loss_us: float = 0.0
    residual: float = 0.0
    l1_error: float = -1.0
    # |mass| the f32 conservative closure injected over the run, relative
    # to the initial mass (0 when the closure is off); budgeted against
    # the known drift scale so the closure cannot hide a conservation bug
    mass_closure_injected_rel: float = 0.0
    # the non-fused stage's global CG mass solves over the whole run, and
    # their iterations (each reads one comparison back from the device)
    cg_solves: int = 0
    cg_iterations: int = 0
    timers: dict | None = None
