"""The limited remap stage in one kernel: wrapper, launch count and plain
PyTorch version.

`mega_stage` is the port of `fused_stage_mega_poly`
(remhos_tpu/ops/pallas_kernels.py:889): the whole -ho 3 -lo 5 -fct 2 stage
(polynomial stage geometry, HO solve, DG upwind face flux, Jacobi GL mass
inverse, MassBasedAvg LO, lumped mass, ClipScale) with only the limited du
written to memory. The kernel is `csrc/mega_stage.cu` (CUDA C++, sm_90a),
built by nvcc at first use and called through ctypes.

On a CUDA tensor the wrapper launches the kernel or raises. On a CPU tensor,
and only then, it runs `mega_stage_reference`, the plain PyTorch version of
the same function built from `lo.mass_based_avg` and `fct.clip_scale`.
"""

from __future__ import annotations

import torch

from .. import fct, lo
from . import stage_core as core
from .stage_core import default_sweeps  # noqa: F401  (part of this API)

# pointer order of Args in csrc/mega_stage.cu: the core's, then these
OPERANDS = core.CORE_OPERANDS + ("smin", "smax", "cls", "du")
STATIC = ("sf", "bdr", "dof_faces", "cls")
NAMES = ("u", "u_nbr", "P", "smin", "smax")       # the per-call operands


def mega_stage_reference(t, dt, u, u_nbr, smin, smax, P, tables, n_cg):
    """Plain PyTorch version of the kernel, on any device.

    t, dt: stage time and limiter dt (rounded to u's dtype, as the kernel
    takes them); u[E, nd]; u_nbr[E, nf*fd]; smin/smax[3^dim, E] class-major
    stencil; P[E, width] (tables.poly_layout); tables from
    tables.stage_ho_tables."""
    tb = tables
    t, dt = core.as_dtype(t, u.dtype), core.as_dtype(dt, u.dtype)
    du_ho, wdet = core.poly_stage_core_reference(t, u, u_nbr, P, tb, n_cg)
    w_q = tb["w_q"]
    du_lo = lo.mass_based_avg(u, du_ho, dt, wdet / w_q, w_q, tb["Bu"])
    ml = wdet @ tb["Bu"]
    cls = tb["cls"].long()
    return fct.clip_scale(u, ml, du_ho, du_lo, smin[cls].T, smax[cls].T, dt)


def _check(u, u_nbr, smin, smax, P, tables):
    """Raise on a dtype, shape or device the kernel does not take (the
    static tables are checked once, where they are built)."""
    E = u.shape[0]
    key = ("mega_shapes", E)
    shapes = tables.get(key)
    if shapes is None:
        ncls = 3 ** tables["dim"]
        shapes = tables[key] = core.operand_shapes(tables, E) + (
            (ncls, E), (ncls, E))
    core.check_operands("mega_stage", NAMES, (u, u_nbr, P, smin, smax),
                        shapes, tables)


def mega_stage(t, dt, u, u_nbr, smin, smax, P, tables):
    """du_limited[E, nd] for one stage, with default_sweeps(u.dtype) Jacobi
    sweeps; see the module docstring."""
    _check(u, u_nbr, smin, smax, P, tables)
    n_cg = default_sweeps(u.dtype)
    if u.device.type == "cpu":
        return mega_stage_reference(t, dt, u, u_nbr, smin, smax, P, tables,
                                    n_cg)
    du = torch.empty_like(u)
    E = u.shape[0]
    lau = core.Launcher.get("mega_stage", "remhos_mega_stage",
                            core.LAUNCH_ARGTYPES, tables, OPERANDS, STATIC,
                            core.core_sizes(tables, E, n_cg))
    lau(u.device, (u.element_size(), tables["dim"]),
        (u, u_nbr, P, smin, smax, du), (float(t), float(dt)), E, n_cg)
    mega_stage.launches += 1
    return du


mega_stage.launches = 0
