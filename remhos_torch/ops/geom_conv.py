"""Stage geometry fused with the volume convection action: wrapper, launch
count and plain PyTorch version.

`geom_conv` is the port of `fused_geom_conv`
(remhos_tpu/ops/pallas_kernels.py:110): from the nodal positions xs, the
nodal mesh velocity v and the field u it forms, at every volume quadrature
point, the Jacobian, its cofactors and determinant, the velocity, the
reference gradient of u and du_q = sign * (adj J v) . grad u, and returns
Ku = du_q (w_q Bu) together with wdet = w_q det J (with `with_wdet=False`
the kernel neither forms nor writes wdet, and the wrapper returns None in
its place). Nothing between the inputs and the outputs reaches memory. The
kernel is `csrc/geom_conv.cu` (CUDA C++, sm_90a): the sum-factorized mesh
geometry of `csrc/mesh_geom.cuh` feeding the stage core of
`csrc/stage_core.cuh`, built by nvcc at first use and called through
ctypes.

On a CUDA tensor the wrapper launches the kernel or raises. On a CPU tensor,
and only then, it runs `geom_conv_reference`.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import geometry as geo
from . import build
from . import stage_core as core
from .tables import (SF_TABLES, check_tables, mesh_factor_block,
                     sum_factor_tables)

_P = ctypes.c_void_p
ARGTYPES = [ctypes.c_int, ctypes.c_int, _P, _P, _P, _P, _P, _P,
            ctypes.c_double, _P, _P, ctypes.POINTER(ctypes.c_int),
            ctypes.c_int, _P]
# the kernel's tables, in the order of its pointer arguments
KERNEL_TABLES = ("sf", "msf", "w_q")


def geom_conv_tables(disc, dtype, device):
    """The static tables, made once per operator. The plain version's dense
    tables, point-minor: GmT[nm, dim, Q], BmT[nm, Q], GuT[nd, dim, Q],
    Buw[Q, nd] = w_q Bu, and w_q[Q]. The kernel's: the core's packed 1D
    factors `sf` (`tables.sum_factor_tables`, SF_TABLES order), the packed
    1D mesh tables `msf` (`tables.mesh_factor_block`), w_q, and the sizes
    D, Q1, m1. nm comes from the mesh order, not from the solution order.
    Raises ValueError where the tables are not Kronecker products. Checked
    once here (`tables.check_tables`)."""
    w_q = np.asarray(disc.w_q, np.float64)

    def F(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=device)

    sf = sum_factor_tables(disc)
    tb = dict(GmT=F(np.asarray(disc.Gm, np.float64).transpose(1, 2, 0)),
              BmT=F(np.asarray(disc.Bm, np.float64).T),
              GuT=F(np.asarray(disc.Gu, np.float64).transpose(1, 2, 0)),
              Buw=F(np.asarray(disc.Bu, np.float64) * w_q[:, None]),
              w_q=F(w_q),
              sf=F(np.concatenate([sf[k].ravel() for k in SF_TABLES])),
              D=sf["D"], **mesh_factor_block(disc, dtype, device))
    nm, dim, Q = tb["GmT"].shape
    nd, D, Q1, m1 = tb["Buw"].shape[1], tb["D"], tb["Q1"], tb["m1"]
    check_tables(tb, shapes=dict(
        GmT=(nm, dim, Q), BmT=(nm, Q), GuT=(nd, dim, Q), Buw=(Q, nd),
        w_q=(Q,), sf=((len(SF_TABLES) - 1) * Q1 * D + D * D,),
        msf=(2 * Q1 * m1,)))
    return tb


def geom_conv_reference(xs, v, u, tables, sign, with_wdet=True):
    """Plain PyTorch version, on any device: (Ku[E, nd], wdet[E, Q] or None
    without `with_wdet`), from the dense tables (Jacobian planes by length-nm
    dots, closed-form cofactors)."""
    dim = xs.shape[-1]
    GmT, GuT = tables["GmT"], tables["GuT"]
    J = geo.jacobian_planes(xs, GmT.permute(2, 0, 1))  # [d][b] -> [E, Q]
    v_q = geo.interp_nodes(v, tables["BmT"].T)         # [E, Q, dim]
    if dim == 3:
        cof = [[J[(d + 1) % 3][(b + 1) % 3] * J[(d + 2) % 3][(b + 2) % 3]
                - J[(d + 1) % 3][(b + 2) % 3] * J[(d + 2) % 3][(b + 1) % 3]
                for b in range(3)] for d in range(3)]
        det = J[0][0] * cof[0][0] + J[0][1] * cof[0][1] + J[0][2] * cof[0][2]
    else:
        cof = [[J[1][1], -J[1][0]], [-J[0][1], J[0][0]]]
        det = J[0][0] * J[1][1] - J[0][1] * J[1][0]
    du_q = None
    for b in range(dim):
        va_b = cof[0][b] * v_q[..., 0]
        for d in range(1, dim):
            va_b = va_b + cof[d][b] * v_q[..., d]
        term = va_b * (u @ GuT[:, b, :])
        du_q = term if du_q is None else du_q + term
    Ku = (sign * du_q) @ tables["Buw"]
    return Ku, tables["w_q"][None, :] * det if with_wdet else None


def _launcher(tables):
    """The C entry bound once per table dict, with the kernel tables'
    pointers and the size array (E, nm, nd, Q, D, Q1, m1; a launch writes
    E)."""
    lau = tables.get("launcher")
    if lau is None:
        lib = build.bind(build.load("geom_conv"), "remhos_geom_conv",
                         ARGTYPES)
        nm, _, Q = tables["GmT"].shape
        sizes = (ctypes.c_int * 7)(0, nm, tables["Buw"].shape[1], Q,
                                   tables["D"], tables["Q1"], tables["m1"])
        lau = tables["launcher"] = (
            lib, lib.remhos_geom_conv, sizes,
            tuple(tables[k].data_ptr() for k in KERNEL_TABLES))
    return lau


def geom_conv(xs, v, u, tables, sign, with_wdet=True):
    """(Ku[E, nd], wdet[E, Q]) for nodes xs[E, nm, dim], nodal velocity
    v[E, nm, dim] and field u[E, nd]; `tables` from `geom_conv_tables`,
    sign +1 (remap) or -1. With `with_wdet=False`, (Ku, None): the kernel
    neither forms nor writes w_q det J. Per call only xs, v and u are
    checked."""
    nm, dim, Q = tables["GmT"].shape
    nd = tables["Buw"].shape[1]
    E = xs.shape[0] if xs.dim() == 3 else -1
    core.check_operands("geom_conv", ("xs", "v", "u"), (xs, v, u),
                        ((E, nm, dim), (E, nm, dim), (E, nd)), tables)
    device = xs.device
    if device.type == "cpu":
        return geom_conv_reference(xs, v, u, tables, sign, with_wdet)
    lib, fn, sizes, ptrs = _launcher(tables)
    sizes[0] = E
    Ku = u.new_empty((E, nd))
    wdet = u.new_empty((E, Q)) if with_wdet else None
    rc = build.call_on(
        device, fn, xs.element_size(), dim, xs.data_ptr(), v.data_ptr(),
        u.data_ptr(), *ptrs, float(sign), Ku.data_ptr(),
        None if wdet is None else wdet.data_ptr(), sizes, 7)
    if rc:
        build.check(lib, rc, "geom_conv")
    geom_conv.launches += 1
    return Ku, wdet


geom_conv.launches = 0
