"""The full HO remap stage with the geometry taken from the nodes: wrapper,
launch count, tables and plain PyTorch version.

`stage_ho_nodes` is the port of `fused_stage_ho`
(remhos_tpu/ops/pallas_kernels.py:490): from the nodes xs, the nodal mesh
velocity v, the field u and its face-neighbour trace u_nbr it forms the
stage geometry (Jacobian, cofactors, det J, the face tangents and normals),
the volume convection, the DG upwind face flux max(0, mode vn) (u_nbr - u)
scattered to the face dofs, and `n_cg` Jacobi sweeps of the GL mass inverse,
returning du_HO[E, nd] and wdet[E, Q] = w_q det J. `n_cg == 0` returns Ku in
place of du_HO; `with_face=False` leaves the face flux out (both phase
ablations). `mode` is +1 (remap) or -1 (transport) and is also the volume
sign. The port's `stage_ho` (kernel 2) is the same stage with the geometry
as polynomials in t; this one derives it from the nodes at every call. The
kernel is `csrc/stage_ho_nodes.cu` (CUDA C++, sm_90a, on the core of
`csrc/stage_core.cuh` that kernels 1 and 2 share), built by nvcc at first
use and called through ctypes.

The TPU wrapper's `block_e` and its VMEM budget choose a TPU tiling; the
port's tile is fixed at compile time, so neither is carried over.

On a CUDA tensor the wrapper launches the kernel or raises. On a CPU tensor,
and only then, it runs `stage_ho_nodes_reference`.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import assembly as asm
from .. import geometry as geo
from . import stage_core as core
from .geom_conv import geom_conv_reference, geom_conv_tables
from .stage_core import default_sweeps
from .tables import check_tables, stage_ho_tables

ARGTYPES = [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_void_p),
            ctypes.c_int, ctypes.c_double, ctypes.POINTER(ctypes.c_int),
            ctypes.c_int, ctypes.c_void_p]
# the kernel's geometry tables, after the core's operands
GEOM_TABLES = ("GmT", "BmT", "GT1", "GT2", "BmfT", "w_q")
# pointer order of Args in csrc/stage_ho_nodes.cu
OPERANDS = (core.CORE_OPERANDS + ("xs", "v") + GEOM_TABLES
            + ("du", "wdet"))
# the record of the one-time check of the geometry tables
CHECKED = "checked_nodes"


def stage_ho_nodes_tables(disc, dtype, device):
    """The static tables, made once: `ops.tables.stage_ho_tables` (the
    core's: GuT, Buw, Bface, SBf, A, AT, Bgl*, Bu, bdr, dof_faces, w_q)
    plus the geometry's, point-minor as the kernel reads them: GmT[nm, dim,
    Q] and BmT[nm, Q] (`geom_conv_tables`'), GT1[nm, FQ] (the first face
    tangent with the reference-normal sign folded in), GT2[nm, FQ] (the
    second, 3D only; None in 2D) and BmfT[nm, FQ]. The plain version reads
    the face tangents as `face_tan` = (Gt[nf, Qf, nm, dim-1], sign[nf]).
    Unpadded, face data per face through bdr: no block-diagonal tables."""
    ft = geo.face_tangent_tables(disc.Gmf, disc.n_ref)
    if ft is None:
        raise NotImplementedError(
            "the stage from the nodes needs axis-aligned reference normals "
            "(ROADMAP.md Queue 1, item 12)")
    Gt, sgn = ft
    nf, Qf, nm, _ = Gt.shape
    FQ = nf * Qf

    def F(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=device)

    def point_minor(a):
        """[nf, Qf, nm] -> [nm, nf*Qf]."""
        return np.asarray(a, np.float64).transpose(2, 0, 1).reshape(nm, FQ)

    tb = stage_ho_tables(disc, dtype, device)
    gc = geom_conv_tables(disc, dtype, device)
    tb.update(GmT=gc["GmT"], BmT=gc["BmT"],
              GT1=F(point_minor(Gt[..., 0] * sgn[:, None, None])),
              GT2=F(point_minor(Gt[..., 1])) if disc.dim == 3 else None,
              BmfT=F(point_minor(disc.Bmf)),
              face_tan=(F(Gt), F(sgn)), nm=nm)
    check_tables(tb, geometry_shapes(tb), key=CHECKED)
    return tb


def geometry_shapes(tb):
    """The shapes of kernel 5's geometry tables."""
    nm, dim, Q = tb["nm"], tb["dim"], tb["Q"]
    FQ = tb["nf"] * tb["Qf"]
    shapes = dict(GmT=(nm, dim, Q), BmT=(nm, Q), GT1=(nm, FQ), BmfT=(nm, FQ))
    if dim == 3:
        shapes["GT2"] = (nm, FQ)
    return shapes


def stage_ho_nodes_reference(xs, v, u, u_nbr, tables, *, mode, n_cg,
                             with_face=True):
    """Plain PyTorch version, on any device: (du_HO or Ku, wdet), composed
    from `geom_conv_reference`, `geometry.face_normals_tangent`, the upwind
    flux with `mode`, `assembly.scatter_face_add` and the Jacobi mass
    inverse of `stage_core.jacobi_gl_inverse`."""
    tb = tables
    E, _, dim = xs.shape
    nd, Q, Qf, nf, fd = (tb[k] for k in ("nd", "Q", "Qf", "nf", "fd"))
    gc = dict(GmT=tb["GmT"], BmT=tb["BmT"], GuT=tb["GuT"].reshape(nd, dim, Q),
              Buw=tb["Buw"], w_q=tb["w_q"])
    Ku, wdet = geom_conv_reference(xs, v, u, gc, mode)
    if with_face:
        nor = geo.face_normals_tangent(xs, *tb["face_tan"])   # [E, nf, Qf, dim]
        v_fq = geo.interp_nodes(v, tb["BmfT"].T).reshape(E, nf, Qf, dim)
        up = (mode * (v_fq * nor).sum(-1)).clamp(min=0.0)
        bdr = tb["bdr"].long()
        Bface = tb["Bface"]
        flux = up * (u_nbr.reshape(E, nf, fd) @ Bface.T - u[:, bdr] @ Bface.T)
        Ku = asm.scatter_face_add(Ku, flux @ tb["SBf"], bdr)
    if n_cg == 0:
        return Ku, wdet
    return core.jacobi_gl_inverse(Ku, wdet, tb, n_cg), wdet


def stage_ho_nodes(xs, v, u, u_nbr, tables, *, mode, n_cg=None,
                   with_face=True):
    """(du_HO[E, nd], wdet[E, Q]) for nodes xs[E, nm, dim], nodal velocity
    v[E, nm, dim], field u[E, nd] and its trace u_nbr[E, nf*fd]; `tables`
    from `stage_ho_nodes_tables`; n_cg Jacobi sweeps (default:
    default_sweeps(u.dtype), 1 in f32 and 8 in f64)."""
    if n_cg is None:
        n_cg = default_sweeps(u.dtype)
    if n_cg < 0:
        raise ValueError(f"n_cg must be >= 0, got {n_cg}")
    if mode not in (1, -1):
        raise ValueError(f"mode must be +1 or -1, got {mode}")
    tb = tables
    if xs.dim() != 3 or xs.shape[2] != tb["dim"]:
        raise ValueError(f"xs must be [E, nm, {tb['dim']}], got "
                         f"{tuple(xs.shape)}")
    E, nm, dim = xs.shape
    if CHECKED not in tb:
        check_tables(tb, geometry_shapes(tb), key=CHECKED)
    shapes = core.operand_shapes(tb, E)[:2] + ((E, tb["nm"], dim),) * 2
    core.check_operands("stage_ho_nodes", ("u", "u_nbr", "xs", "v"),
                        (u, u_nbr, xs, v), shapes, tb, key=CHECKED)
    if u.device.type == "cpu":
        return stage_ho_nodes_reference(xs, v, u, u_nbr, tb, mode=mode,
                                        n_cg=n_cg, with_face=with_face)
    du = torch.empty_like(u)
    wdet = torch.empty((E, tb["Q"]), dtype=u.dtype, device=u.device)
    lau = core.Launcher.get(
        "stage_ho_nodes", "remhos_stage_ho_nodes", ARGTYPES, tb, OPERANDS,
        core.CORE_OPERANDS[3:] + GEOM_TABLES,
        core.core_sizes(tb, E, n_cg) + [nm, 1])
    lau(u.device, (u.element_size(), dim),
        (u, u_nbr, None, xs, v, du, wdet), (float(mode),), E, n_cg, nm,
        int(bool(with_face)))
    stage_ho_nodes.launches += 1
    return du, wdet


stage_ho_nodes.launches = 0
