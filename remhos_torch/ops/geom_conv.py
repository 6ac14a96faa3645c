"""Stage geometry fused with the volume convection action: wrapper, launch
count and plain PyTorch version.

`geom_conv` is the port of `fused_geom_conv`
(remhos_tpu/ops/pallas_kernels.py:110): from the nodal positions xs, the
nodal mesh velocity v and the field u it forms, at every volume quadrature
point, the Jacobian, its cofactors and determinant, the velocity, the
reference gradient of u and du_q = sign * (adj J v) . grad u, and returns
Ku = du_q (w_q Bu) together with wdet = w_q det J. Nothing between the
inputs and the two outputs reaches memory. The kernel is
`csrc/geom_conv.cu` (CUDA C++, sm_90a), built by nvcc at first use and
called through ctypes.

On a CUDA tensor the wrapper launches the kernel or raises. On a CPU tensor,
and only then, it runs `geom_conv_reference`.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import geometry as geo
from . import build

_P = ctypes.c_void_p
ARGTYPES = [ctypes.c_int, ctypes.c_int, _P, _P, _P, _P, _P, _P, _P, _P,
            ctypes.c_double, _P, _P, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, _P]
# the kernel's tables, in the order of its pointer arguments
KERNEL_TABLES = ("GmT", "BmT", "GuT", "Buw", "w_q")


def geom_conv_tables(disc, dtype, device):
    """The static tables, made once per operator, point-minor as the kernel
    reads them: GmT[nm, dim, Q], BmT[nm, Q], GuT[nd, dim, Q] (the plain
    version reads the same through views), Buw[Q, nd] = w_q Bu and w_q[Q].
    nm comes from the mesh order, not from the solution order."""
    w_q = np.asarray(disc.w_q, np.float64)

    def F(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=device)

    return dict(GmT=F(np.asarray(disc.Gm, np.float64).transpose(1, 2, 0)),
                BmT=F(np.asarray(disc.Bm, np.float64).T),
                GuT=F(np.asarray(disc.Gu, np.float64).transpose(1, 2, 0)),
                Buw=F(np.asarray(disc.Bu, np.float64) * w_q[:, None]),
                w_q=F(w_q))


def geom_conv_reference(xs, v, u, tables, sign):
    """Plain PyTorch version, on any device: (Ku[E, nd], wdet[E, Q]), with
    the kernel's arithmetic (Jacobian planes, closed-form cofactors)."""
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
    return (sign * du_q) @ tables["Buw"], tables["w_q"][None, :] * det


def geom_conv(xs, v, u, tables, sign):
    """(Ku[E, nd], wdet[E, Q]) for nodes xs[E, nm, dim], nodal velocity
    v[E, nm, dim] and field u[E, nd]; `tables` from `geom_conv_tables`,
    sign +1 (remap) or -1."""
    if xs.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"geom_conv takes float32 or float64, got {xs.dtype}")
    if xs.dim() != 3 or xs.shape[2] not in (2, 3):
        raise ValueError(f"xs must be [E, nm, 2 or 3], got {tuple(xs.shape)}")
    E, nm, dim = xs.shape
    Q = tables["w_q"].shape[0]
    nd = tables["Buw"].shape[1]
    shapes = dict(v=(E, nm, dim), u=(E, nd), GmT=(nm, dim, Q), BmT=(nm, Q),
                  GuT=(nd, dim, Q), Buw=(Q, nd), w_q=(Q,))
    operands = dict(v=v, u=u, **{k: tables[k] for k in KERNEL_TABLES})
    for name, x in operands.items():
        if tuple(x.shape) != shapes[name]:
            raise ValueError(f"{name} must be {shapes[name]}, got "
                             f"{tuple(x.shape)}")
        if x.dtype != xs.dtype:
            raise TypeError(f"{name} is {x.dtype}, must be {xs.dtype}")
        if x.device != xs.device:
            raise ValueError(f"{name} is on {x.device}, xs on {xs.device}")
    if xs.device.type == "cpu":
        return geom_conv_reference(xs, v, u, tables, sign)
    if xs.device.type != "cuda":
        raise ValueError(f"geom_conv runs on cuda or cpu, not {xs.device}")
    operands["xs"] = xs
    for name, x in operands.items():
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    Ku = torch.empty((E, nd), dtype=xs.dtype, device=xs.device)
    wdet = torch.empty((E, Q), dtype=xs.dtype, device=xs.device)
    lib = build.bind(build.load("geom_conv"), "remhos_geom_conv", ARGTYPES)
    with torch.cuda.device(xs.device):
        stream = torch.cuda.current_stream(xs.device).cuda_stream
        rc = lib.remhos_geom_conv(
            xs.element_size(), dim, xs.data_ptr(), v.data_ptr(),
            u.data_ptr(), *[tables[k].data_ptr() for k in KERNEL_TABLES],
            float(sign), Ku.data_ptr(), wdet.data_ptr(), E, nm, nd, Q,
            stream)
    build.check(lib, rc, "geom_conv")
    geom_conv.launches += 1
    return Ku, wdet


geom_conv.launches = 0
