"""The unlimited HO remap stage in one kernel: wrapper, launch count and
plain PyTorch version.

`stage_ho` is the port of `fused_stage_ho_poly`
(remhos_tpu/ops/pallas_kernels.py:809): polynomial stage geometry, volume
convection, DG upwind face flux and the Jacobi GL mass inverse, returning
du_HO[E, nd] and the stage's wdet[E, Q] = w_q det J, and with `with_lo` also
the MassBasedAvg LO solution du_LO[E, nd] at the limiter dt. `n_cg == 0`
returns Ku in place of du_HO (and of du_LO). The kernel is
`csrc/stage_ho.cu` (CUDA C++, sm_90a; its core `csrc/stage_core.cuh` is
shared with the mega stage kernel), built by nvcc at first use and called
through ctypes.

On a CUDA tensor the wrapper launches the kernel or raises. On a CPU tensor,
and only then, it runs `stage_ho_poly_reference`.
"""

from __future__ import annotations

import torch

from .. import lo
from . import build
from . import stage_core as core
from .stage_core import default_sweeps


def stage_ho_poly_reference(t, u, u_nbr, P, tables, n_cg, dt=None,
                            with_lo=False):
    """Plain PyTorch version of the kernel, on any device: (du_HO, wdet) or
    (du_HO, wdet, du_LO). The LO average keeps the reference's quadrature
    form (`lo.mass_based_avg`); the kernel takes it in the lumped-mass
    metric, which is the same number in real arithmetic."""
    t = core.as_dtype(t, u.dtype)
    du, wdet = core.poly_stage_core_reference(t, u, u_nbr, P, tables, n_cg)
    if not with_lo:
        return du, wdet
    if n_cg == 0:
        return du, wdet, du.clone()
    w_q = tables["w_q"]
    dt = core.as_dtype(dt, u.dtype)
    return du, wdet, lo.mass_based_avg(u, du, dt, wdet / w_q, w_q,
                                       tables["Bu"])


def stage_ho(t, u, u_nbr, P, tables, n_cg=None, dt=None, with_lo=False):
    """(du_HO[E, nd], wdet[E, Q][, du_LO[E, nd]]) for one field at stage time
    t; n_cg Jacobi sweeps (default: default_sweeps(u.dtype)); `dt`, the
    limiter's dt, is needed with `with_lo`."""
    if n_cg is None:
        n_cg = default_sweeps(u.dtype)
    if n_cg < 0:
        raise ValueError(f"n_cg must be >= 0, got {n_cg}")
    if with_lo and dt is None:
        raise ValueError("with_lo needs the limiter dt")
    names = core.CORE_OPERANDS
    ops = dict(u=u, u_nbr=u_nbr, P=P, **{k: tables[k] for k in names[3:]})
    core.check_operands("stage_ho", ops, core.core_shapes(tables, u.shape[0]),
                        core.INT_TABLES)
    if u.device.type == "cpu":
        return stage_ho_poly_reference(t, u, u_nbr, P, tables, n_cg, dt=dt,
                                       with_lo=with_lo)
    du = torch.empty_like(u)
    wdet = torch.empty((u.shape[0], tables["Q"]), dtype=u.dtype,
                       device=u.device)
    du_lo = torch.empty_like(u) if with_lo else None
    lib = build.bind(build.load("stage_ho"), "remhos_stage_ho",
                     core.LAUNCH_ARGTYPES)
    rc = core.launch(lib, "remhos_stage_ho",
                     [ops[k] for k in names] + [du, wdet, du_lo], u, tables,
                     t, 0.0 if dt is None else dt, n_cg)
    build.check(lib, rc, "stage_ho")
    stage_ho.launches += 1
    return (du, wdet, du_lo) if with_lo else (du, wdet)


stage_ho.launches = 0
