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


class GatherLayout:
    """One structured layout's constants, made and checked once: the grid
    `shape` (element e = ix + nx iy + nx ny iz) with per-axis `periodic`
    flags; nbr_dof_local[nf, fd] (array or tensor), the neighbour-side dof
    of each face dof, copied to `device` as int32; its largest entry, the
    output width and the ctypes size block of the C entry (dim, nf, fd,
    nd = 0, the grid, the periodic flags, each face's axis and side; nd is
    u's, per call). Build one per (shape, periodic, nbr_dof_local, device)
    and pass it to every `gather_nbr` call on that layout."""

    def __init__(self, shape, periodic, nbr_dof_local, device):
        self.shape = tuple(int(n) for n in shape)
        self.periodic = tuple(bool(p) for p in periodic)
        dim = len(self.shape)
        if not 1 <= dim <= 3 or len(self.periodic) != dim:
            raise ValueError(f"shape and periodic must name 1-3 axes, got "
                             f"{shape} and {periodic}")
        self.E = int(np.prod(self.shape))
        nbr = torch.as_tensor(nbr_dof_local)
        if nbr.dim() != 2 or nbr.shape[0] != 2 * dim:
            raise ValueError(f"nbr_dof_local must be [{2 * dim}, fd], got "
                             f"{tuple(nbr.shape)}")
        self.device = torch.device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.nbr = nbr.to(device=self.device, dtype=torch.int32,
                          copy=True).contiguous()
        nf, fd = self.nbr.shape
        self.width = nf * fd
        self.nd_min = int(self.nbr.max()) + 1 if self.nbr.numel() else 0
        if self.nbr.numel() and int(self.nbr.min()) < 0:
            raise ValueError("nbr_dof_local holds a negative dof")
        faces = faces_for_dim(dim)
        vals = ([dim, nf, fd, 0] + list(self.shape)
                + [int(p) for p in self.periodic] + [a for a, _ in faces]
                + [s for _, s in faces])
        self.sizes = (ctypes.c_int * len(vals))(*vals)
        self.nsizes = len(vals)
        self.nbr_ptr = self.nbr.data_ptr() if self.device.type == "cuda" \
            else 0
        self.nd = 0                     # u's row length in sizes[3]
        self.fn = self.lib = None       # the C entry, bound at first launch


def gather_nbr(u, layout):
    """u_nbr[E, nf*fd] of u[E, nd] on `layout` (a `GatherLayout` on u's
    device). Per call only u is checked."""
    dev = u.device
    if dev != layout.device:
        raise ValueError(f"u is on {dev}, the layout on {layout.device}")
    try:
        E, nd = u.shape
    except ValueError:
        E = nd = -1
    if E != layout.E or nd < layout.nd_min:
        raise ValueError(f"u must be [{layout.E}, nd >= {layout.nd_min}], got "
                         f"{tuple(u.shape)}")
    if dev.type != "cuda":
        if dev.type == "cpu":
            return gather_nbr_reference(u, layout.shape, layout.periodic,
                                        layout.nbr)
        raise ValueError(f"gather_nbr runs on cuda or cpu, not {dev}")
    size = u.element_size()
    if size not in (2, 4, 8):
        raise TypeError(f"gather_nbr takes 2, 4 or 8 byte elements, got "
                        f"{u.dtype}")
    if not u.is_contiguous():
        raise ValueError("u must be contiguous")
    out = u.new_empty(E, layout.width)
    if nd != layout.nd:
        layout.sizes[3] = layout.nd = nd
    fn = layout.fn
    if fn is None:
        layout.lib = build.bind(build.load("gather_nbr"), "remhos_gather_nbr",
                             ARGTYPES)
        fn = layout.fn = layout.lib.remhos_gather_nbr
    rc = build.call_on(dev, fn, size, u.data_ptr(), layout.nbr_ptr,
                       out.data_ptr(), layout.sizes, layout.nsizes)
    if rc:
        build.check(layout.lib, rc, "gather_nbr")
    gather_nbr.launches += 1
    return out


gather_nbr.launches = 0
