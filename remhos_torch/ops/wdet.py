"""w_q det J at the volume rule from nodal positions: wrapper, launch count
and plain PyTorch version.

`wdet` is the port of `fused_wdet` (remhos_tpu/ops/pallas_kernels.py:1130):
the Jacobian at every volume quadrature point by a length-nm dot against
the mesh gradient table, its closed-form determinant, times the quadrature
weight; J never reaches memory. The kernel is `csrc/wdet.cu` (CUDA C++,
sm_90a), built by nvcc at first use and called through ctypes.

On a CUDA tensor the wrapper launches the kernel or raises. On a CPU tensor,
and only then, it runs `wdet_reference`.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import geometry as geo
from . import build

ARGTYPES = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p]


def wdet_tables(disc, dtype, device):
    """The kernel's static tables: Gm[Q, nm, dim] (the plain version reads
    it), the same point-minor as GmT[nm, dim, Q] (the kernel reads it) and
    w_q[Q]. nm comes from the mesh order, not from the solution order."""
    Gm = np.asarray(disc.Gm, np.float64)

    def F(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=device)

    return dict(Gm=F(Gm), GmT=F(Gm.transpose(1, 2, 0)), w_q=F(disc.w_q))


def wdet_reference(xs, tables):
    """Plain PyTorch version, on any device: w_q det J [E, Q]."""
    return tables["w_q"][None, :] * geo.volume_detj(xs, tables["Gm"])


def wdet(xs, tables):
    """wdet[E, Q] = w_q det J at the volume rule for nodes xs[E, nm, dim]."""
    GmT, w_q = tables["GmT"], tables["w_q"]
    if xs.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"wdet takes float32 or float64, got {xs.dtype}")
    if xs.dim() != 3 or xs.shape[2] not in (2, 3):
        raise ValueError(f"xs must be [E, nm, 2 or 3], got {tuple(xs.shape)}")
    E, nm, dim = xs.shape
    Q = w_q.shape[0]
    if tuple(GmT.shape) != (nm, dim, Q):
        raise ValueError(f"GmT must be {(nm, dim, Q)}, got "
                         f"{tuple(GmT.shape)}")
    for name, x in (("GmT", GmT), ("w_q", w_q)):
        if x.dtype != xs.dtype:
            raise TypeError(f"{name} is {x.dtype}, must be {xs.dtype}")
        if x.device != xs.device:
            raise ValueError(f"{name} is on {x.device}, xs on {xs.device}")
    if xs.device.type == "cpu":
        return wdet_reference(xs, tables)
    if xs.device.type != "cuda":
        raise ValueError(f"wdet runs on cuda or cpu, not {xs.device}")
    for name, x in (("xs", xs), ("GmT", GmT), ("w_q", w_q)):
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    out = torch.empty((E, Q), dtype=xs.dtype, device=xs.device)
    lib = build.bind(build.load("wdet"), "remhos_wdet", ARGTYPES)
    with torch.cuda.device(xs.device):
        stream = torch.cuda.current_stream(xs.device).cuda_stream
        rc = lib.remhos_wdet(xs.element_size(), dim, xs.data_ptr(),
                             GmT.data_ptr(), w_q.data_ptr(), out.data_ptr(),
                             E, nm, Q, stream)
    build.check(lib, rc, "wdet")
    wdet.launches += 1
    return out


wdet.launches = 0
