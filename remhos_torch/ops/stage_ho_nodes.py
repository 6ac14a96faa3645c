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
kernel is `csrc/stage_ho_nodes.cu` (CUDA C++, sm_90a): the sum-factorized
mesh geometry of `csrc/mesh_geom.cuh` (kernels 3 and 4's, with its face
part: tangents and v . n from each face's nodes, as `face_descriptors`
describe them) feeding the core of `csrc/stage_core.cuh` that kernels 1
and 2 share, built by nvcc at first use and called through ctypes.

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
from .tables import check_tables, face_descriptors, stage_ho_tables

ARGTYPES = [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_void_p),
            ctypes.c_int, ctypes.c_double, ctypes.POINTER(ctypes.c_int),
            ctypes.c_int, ctypes.c_void_p]
# the kernel's geometry tables, after the core's operands
GEOM_TABLES = ("msf", "fdesc", "w_q")
# pointer order of the C interface of csrc/stage_ho_nodes.cu
OPERANDS = (core.CORE_OPERANDS + ("xs", "v") + GEOM_TABLES
            + ("du", "wdet"))
# the record of the one-time check of the geometry tables
CHECKED = "checked_nodes"


def stage_ho_nodes_tables(disc, dtype, device):
    """The static tables, made once: `ops.tables.stage_ho_tables` (the
    core's: the 1D factors sf, the dense tables of the plain version, bdr,
    dof_faces, w_q) plus the geometry's. The kernel reads the packed 1D
    mesh tables msf (`tables.mesh_factor_block`) and the face descriptors
    fdesc[nf, 5] (`tables.face_descriptors`, which raises unless they and
    msf rebuild the dense face tables); the plain version reads the dense
    GmT[nm, dim, Q] and BmT[nm, Q] (`geom_conv_tables`'), BmfT[nm, FQ] and
    the face tangents as `face_tan` = (Gt[nf, Qf, nm, dim-1], sign[nf])."""
    fdesc = face_descriptors(disc)     # raises without axis-aligned normals
    Gt, sgn = geo.face_tangent_tables(disc.Gmf, disc.n_ref)
    nf, Qf, nm, _ = Gt.shape

    def F(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=device)

    tb = stage_ho_tables(disc, dtype, device)
    gc = geom_conv_tables(disc, dtype, device)
    tb.update(GmT=gc["GmT"], BmT=gc["BmT"], msf=gc["msf"], m1=gc["m1"],
              BmfT=F(np.asarray(disc.Bmf, np.float64).transpose(2, 0, 1)
                     .reshape(nm, nf * Qf)),
              fdesc=torch.as_tensor(fdesc, device=device),
              face_tan=(F(Gt), F(sgn)), nm=nm)
    check_tables(tb, geometry_shapes(tb), key=CHECKED)
    return tb


def geometry_shapes(tb):
    """The shapes of kernel 5's geometry tables (the kernel's and the plain
    version's)."""
    nm, dim, Q, m1, Q1 = (tb[k] for k in ("nm", "dim", "Q", "m1", "Q1"))
    nf = tb["nf"]
    return dict(GmT=(nm, dim, Q), BmT=(nm, Q), BmfT=(nm, nf * tb["Qf"]),
                msf=(2 * Q1 * m1,), fdesc=(nf, 5))


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
        core.core_sizes(tb, E, n_cg) + [nm, 1, tb["m1"]])
    lau(u.device, (u.element_size(), dim),
        (u, u_nbr, None, xs, v, du, wdet), (float(mode),), E, n_cg, nm,
        int(bool(with_face)))
    stage_ho_nodes.launches += 1
    return du, wdet


stage_ho_nodes.launches = 0
