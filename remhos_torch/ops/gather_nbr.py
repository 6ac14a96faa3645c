"""The structured neighbour face-dof gather in one kernel: wrapper, launch
count and plain PyTorch version.

`gather_nbr` is the port of `gather_nbr_flat`
(remhos_tpu/ops/pallas_kernels.py:1280, tables from `gather_nbr_flat_meta`
:1227): u_nbr[e, f*fd + i] = u[nbr(e, f), nbr_dof_local[f, i]], 0 where the
face lies on a physical edge, wrapped on a periodic axis. It equals
`structured.gather_nbr_structured(...).reshape(E, -1)` bit for bit in every
dtype it takes (2, 4 or 8 bytes an element), on every structured layout:
the TPU meta's condition on the block size (a multiple of 8, else the
caller falls back to XLA) is a TPU tiling matter, and the port has no such
fallback. The kernel is `csrc/gather_nbr.cu` (CUDA C++, sm_90a), built by
nvcc at first use and called through ctypes.

The operator does not call it: `Advection.gather_nbr` keeps the plain index
gather, as the JAX operator keeps its XLA gather (the TPU kernel is a
measured negative result there, pallas_kernels.py:1170-1180).

On a CUDA tensor the wrapper launches the kernel or raises. On a CPU tensor,
and only then, it runs `gather_nbr_reference`.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import structured as strm
from ..mesh import faces_for_dim
from . import build

_P = ctypes.c_void_p
ARGTYPES = [ctypes.c_int, _P, _P, _P, ctypes.POINTER(ctypes.c_int),
            ctypes.c_int, _P]


def gather_nbr_reference(u, shape, periodic, nbr_dof_local):
    """Plain PyTorch version, on any device: u_nbr[E, nf*fd]."""
    return strm.gather_nbr_structured(u, shape, periodic,
                                      nbr_dof_local).reshape(u.shape[0], -1)


def gather_nbr(u, shape, periodic, nbr_dof_local):
    """u_nbr[E, nf*fd] of u[E, nd] on the structured grid `shape` (element
    e = ix + nx iy + nx ny iz) with per-axis `periodic` flags;
    nbr_dof_local[nf, fd] (array or tensor; an int32 tensor on u's device
    is used as it is) gives the neighbour-side dof of each face dof."""
    dim = len(shape)
    if u.dim() != 2 or u.shape[0] != int(np.prod(shape)):
        raise ValueError(f"u must be [{int(np.prod(shape))}, nd], got "
                         f"{tuple(u.shape)}")
    nbr = torch.as_tensor(nbr_dof_local, device=u.device)
    if nbr.dim() != 2 or nbr.shape[0] != 2 * dim:
        raise ValueError(f"nbr_dof_local must be [{2 * dim}, fd], got "
                         f"{tuple(nbr.shape)}")
    if u.device.type == "cpu":
        return gather_nbr_reference(u, shape, periodic, nbr)
    if u.device.type != "cuda":
        raise ValueError(f"gather_nbr runs on cuda or cpu, not {u.device}")
    if u.element_size() not in (2, 4, 8):
        raise TypeError(f"gather_nbr takes 2, 4 or 8 byte elements, got "
                        f"{u.dtype}")
    if not u.is_contiguous():
        raise ValueError("u must be contiguous")
    nbr = nbr.to(torch.int32).contiguous()
    E, nd = u.shape
    nf, fd = nbr.shape
    out = torch.empty((E, nf * fd), dtype=u.dtype, device=u.device)
    faces = faces_for_dim(dim)
    vals = ([dim, nf, fd, nd] + [int(n) for n in shape]
            + [int(bool(p)) for p in periodic] + [a for a, _ in faces]
            + [s for _, s in faces])
    sizes = (ctypes.c_int * len(vals))(*vals)
    lib = build.bind(build.load("gather_nbr"), "remhos_gather_nbr", ARGTYPES)
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream(u.device).cuda_stream
        rc = lib.remhos_gather_nbr(u.element_size(), u.data_ptr(),
                                   nbr.data_ptr(), out.data_ptr(), sizes,
                                   len(vals), stream)
    build.check(lib, rc, "gather_nbr")
    gather_nbr.launches += 1
    return out


gather_nbr.launches = 0
