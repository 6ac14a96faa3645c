"""Entry points for a harness: one jittable-equivalent step, and a dry run
of the sharded step over n ranks (the port of `__graft_entry__.py`).

Both run on the card unless the caller passes device="cpu" (None means
CUDA, and raises without it).

- `entry(device)`: (fn, example_args), fn(S, t, dt) -> S_new one canonical
  RK3 step (-ho 3 -lo 5 -fct 2) of the p=3 3D remap configuration on
  cube01_hex, on one device.
- `dryrun_multichip(n, device)`: the full sharded step over n ranks of a
  process group (gloo processes on the CPU; on one card, gloo ranks sharing
  it), one step on tiny shapes,
  against the unsharded step of the same state, to < 1e-13, in four legs:
  plain (the assembled path with -dtc 1 -bt 1 on a 2-D shard grid where n
  is composite), production (-pa, kernel 1's "E" variant on the shards),
  weak scaling (the `-m default -epm` mesh of n x 64 elements) and a
  general mesh (built in code from a 6 x 6 grid, Morton blocks with ghost
  padding where n does not divide 36). Returns rank 0's max differences.
"""

from __future__ import annotations

import torch

from . import problems as prob
from . import resolve_device
from . import steppers
from .discretization import build_discretization
from .driver import integrate_mesh_velocity, project_bernstein
from .mesh import default_mesh, load_mesh, make_cartesian_mesh
from .operator import Advection, SolverConfig


def _setup(mesh, problem, order, device, t_final=0.75, dt=0.02):
    """(disc, x0, v, S) of a remap or transport case in f64, on `device`
    (None: CUDA)."""
    device = resolve_device(device)
    disc = build_discretization(mesh, order)
    x0 = torch.as_tensor(mesh.x, dtype=torch.float64, device=device)
    v = None
    if prob.exec_mode_of(problem) == 1:
        v = integrate_mesh_velocity(x0, problem, mesh.bb_min, mesh.bb_max,
                                    t_final, dt)
    u0, _ = project_bernstein(
        x0, disc.Bm_at_unodes,
        lambda x: prob.u0_function(problem, x, mesh.bb_min, mesh.bb_max))
    return disc, x0, v, u0[None]


def entry(device=None):
    """(fn, example_args): one RK3 step of the flagship p=3 3D remap
    configuration (cube01_hex refined once, -ho 3 -lo 5 -fct 2, assembled
    as the JAX entry's default SolverConfig is) on one device (None:
    CUDA)."""
    device = resolve_device(device)
    mesh = load_mesh("cube01_hex", 1)
    disc, x0, v, S = _setup(mesh, 10, 3, device)
    scfg = SolverConfig(problem=10, ho=3, lo=5, fct=2, ode_solver=3,
                        pa=False)
    adv = Advection(disc, scfg, x0, v, dtype=torch.float64, device=device)
    step = steppers.make_rk_step(adv.stage_function(), 3)

    def fn(S, t, dt):
        return step(S, t, dt)[0]

    return fn, (S, 0.1, 0.02)


def _leg(mesh, scfg, order, grid, device, t_final=0.7, dt_v=0.1,
         dt=0.01):
    """max |sharded step - unsharded step| over the live rows, on every
    rank of the current process group."""
    from .parallel import launch
    from .parallel.sharded import make_sharded_step, shard_arrays
    disc, x0, v, S = _setup(mesh, scfg.problem, order, device, t_final, dt_v)
    comm, sstep, perm = make_sharded_step(mesh, scfg, order, grid, 3,
                                          group=launch.current_group(),
                                          device=device)
    E = mesh.num_elements
    S_l, x0_l, v_l, _ = shard_arrays(comm, S, x0, v, None, perm=perm,
                                     n_real=E)
    S_new, aux = sstep(S_l, 0.0, dt, x0_l, v_l, None)
    assert torch.isfinite(S_new).all()
    if scfg.dt_control:
        assert torch.isfinite(aux[0])       # aux = [dt_ratio, -violations]
    g = comm.all_gather(S_new.transpose(0, 1).contiguous())[:E]
    adv1 = Advection(disc, scfg, x0, v, dtype=torch.float64, device=device)
    S1, _ = steppers.make_rk_step(adv1.stage_function(), 3)(S, 0.0, dt)
    ref = S1[:, torch.as_tensor(perm[:E], device=S1.device)].transpose(0, 1)
    return float((g - ref).abs().max())


def _dryrun_rank(n, device):
    """Every rank's part of `dryrun_multichip`: the four legs."""
    sy = next((c for c in (2, 3, 4) if n % c == 0 and n // c > 1), 1)
    sz = n // sy
    grid = (sy, sz) if sy > 1 else (n,)
    mesh = make_cartesian_mesh(3, (2, 2 * sy, 2 * sz), (0, 0, 0), (1, 1, 1),
                               (False, False, False))
    out = {"grid": grid}
    out["plain"] = _leg(mesh, SolverConfig(
        problem=10, ho=3, lo=5, fct=2, ode_solver=3, dt_control=1,
        bounds_type=1, pa=False), 2, grid, device)
    out["production"] = _leg(mesh, SolverConfig(
        problem=10, ho=3, lo=5, fct=2, ode_solver=3, pa=True), 2, grid,
        device)
    out["weak_scaling"] = _leg(default_mesh(3, n, 64), SolverConfig(
        problem=10, ho=3, lo=5, fct=2, ode_solver=3, pa=False), 2, (n,),
        device)
    from . import umesh
    from .vis import _structured_corner_ids
    grid2 = make_cartesian_mesh(2, (6, 6), (0, 0), (1, 1), (False, False))
    corners, _ = _structured_corner_ids(grid2)
    pos = grid2.x[:, [0, 2, 6, 8]]          # the corner nodes of order 2
    gm = umesh.from_arrays(corners, pos, 2)
    out["general_mesh"] = _leg(gm, SolverConfig(
        problem=1, ho=3, lo=3, fct=2, ode_solver=3, pa=False), 2, (n,),
        device, dt=0.005)
    for k in ("plain", "production", "weak_scaling", "general_mesh"):
        if not out[k] < 1e-13:
            raise AssertionError(f"dryrun_multichip {k}: sharded != "
                                 f"unsharded, max diff {out[k]:.3e}")
    return out


def dryrun_multichip(n_devices: int, device=None) -> dict:
    """The sharded step over n_devices ranks (gloo processes on the CPU;
    None: CUDA) against the unsharded step, in four legs; raises past
    1e-13. Returns {leg: max difference} and the shard grid."""
    from .parallel import launch
    device = resolve_device(device)
    out = launch.spawn(_dryrun_rank, n_devices, device, n_devices, device)
    print(f"dryrun_multichip: {n_devices} ranks (grid {out['grid']}), "
          + ", ".join(f"{k} max|sharded-unsharded|={out[k]:.3e}"
                      for k in ("plain", "production", "weak_scaling",
                                "general_mesh")) + " - OK")
    return out
