"""Structured-grid halos: the face-neighbour gather and the overlap-bounds
stencil as element-axis shifts (the `remhos_tpu.structured` subset on the
main path).

Grid layout: element e = ix + nx*iy + nx*ny*iz, so a step along mesh axis a
is a flat shift by stride_a = prod(shape[:a]). A flat roll crosses the axis
boundary on the edge rows; those rows are patched: with 0 (gather) or +-inf
(stencil) on a physical edge, with the complementary wrap roll on a periodic
axis.

The TPU version extracts the face dofs with a one-hot matmul (an MXU device,
at 3-pass bf16 precision in f32). Here it is an exact index gather in every
dtype.
"""

from __future__ import annotations

import numpy as np
import torch

from .mesh import faces_for_dim

INF = float("inf")


def _strides(shape):
    strides = [1]
    for a in range(1, len(shape)):
        strides.append(strides[-1] * shape[a - 1])
    return strides


def _edge_mask(E, shape, axis, side, device=None):
    """Boolean [E]: element lies on the (axis, side) edge of the grid."""
    dim = len(shape)
    m = np.zeros(tuple(reversed(shape)), dtype=bool)
    idx = [slice(None)] * dim
    idx[dim - 1 - axis] = -1 if side == 1 else 0
    m[tuple(idx)] = True
    return torch.as_tensor(m.reshape(E), device=device)


def edge_masks(shape, device=None):
    """{(axis, side): [E] bool} for every grid edge, built once per mesh."""
    E = int(np.prod(shape))
    return {(a, s): _edge_mask(E, shape, a, s, device)
            for a in range(len(shape)) for s in (0, 1)}


def _flat_face_rolls(uf, shape, periodic, fd, masks):
    """Per-face neighbour blocks [E, fd] from the flat face trace
    uf[E, nf*fd] by element-axis rolls; physical edges read 0."""
    strides = _strides(shape)
    outs = []
    for f, (axis, side) in enumerate(faces_for_dim(len(shape))):
        dirn = 1 if side == 1 else -1
        blk = uf[:, f * fd:(f + 1) * fd]
        r1 = torch.roll(blk, -dirn * strides[axis], dims=0)
        edge = masks[(axis, side)][:, None]
        if periodic[axis]:
            wrap = -dirn * (shape[axis] - 1) * strides[axis]
            nb = torch.where(edge, torch.roll(blk, -wrap, dims=0), r1)
        else:
            nb = torch.where(edge, 0.0, r1)
        outs.append(nb)
    return outs


def gather_nbr_structured(u, shape, periodic, nbr_dof_local, masks=None):
    """u_nbr[E, nf, fd]: each element's face-neighbour dof values, 0 on
    physical boundaries (ExchangeFaceNbrData equivalent). Exact in every
    dtype: an index gather plus element-axis rolls, no arithmetic.
    Column f*fd + i of the flat trace is the neighbour-side dof of face f's
    i-th face dof (the index form of the TPU's one-hot
    `_face_gather_matrix`)."""
    if masks is None:
        masks = edge_masks(shape, u.device)
    nbr = torch.as_tensor(nbr_dof_local, device=u.device, dtype=torch.long)
    fd = nbr.shape[1]
    uf = u.index_select(1, nbr.reshape(-1))
    return torch.stack(_flat_face_rolls(uf, shape, periodic, fd, masks),
                       dim=1)


def overlap_stencil_T(el_min, el_max, shape, periodic, masks=None):
    """Element-class overlap-bounds stencil in class-major [3^dim, E] layout.

    Per axis an element has 3 dof classes: the low GLL endpoint (sees the
    low neighbour's extremum), the interior (own element only) and the high
    endpoint. The class index is cz*9 + cy*3 + cx (x fastest). Equals the
    CG scatter-min/max of ComputeOverlapBounds (remhos_tools.cpp:432-495)
    on a structured grid. Returns (min, max), each [3^dim, E]."""
    if masks is None:
        masks = edge_masks(shape, el_min.device)
    strides = _strides(shape)
    Wmin, Wmax = el_min[None, :], el_max[None, :]
    for axis in range(len(shape)):
        s, n = strides[axis], shape[axis]
        segs_min, segs_max = [Wmin], [Wmax]
        for side in (0, 1):
            edge = masks[(axis, side)][None, :]
            dirn = 1 if side == 1 else -1
            nmin = torch.roll(Wmin, -dirn * s, dims=1)
            nmax = torch.roll(Wmax, -dirn * s, dims=1)
            if periodic[axis]:
                wrap = dirn * (n - 1) * s
                nmin = torch.where(edge, torch.roll(Wmin, wrap, dims=1), nmin)
                nmax = torch.where(edge, torch.roll(Wmax, wrap, dims=1), nmax)
            else:
                nmin = torch.where(edge, INF, nmin)
                nmax = torch.where(edge, -INF, nmax)
            nmin = torch.minimum(Wmin, nmin)
            nmax = torch.maximum(Wmax, nmax)
            if side == 0:
                segs_min.insert(0, nmin)
                segs_max.insert(0, nmax)
            else:
                segs_min.append(nmin)
                segs_max.append(nmax)
        Wmin = torch.cat(segs_min, dim=0)
        Wmax = torch.cat(segs_max, dim=0)
    return Wmin, Wmax


def overlap_bounds_structured(el_min, el_max, shape, periodic, p,
                              active_el=None, masks=None, cls=None):
    """Per-dof overlap bounds (x_min[E, nd], x_max[E, nd]): per axis, a GLL
    endpoint dof also sees the adjacent element's extremum; interior dofs
    see only their own element. Equals the CG scatter-min/max of
    ComputeOverlapBounds (remhos_tools.cpp:432-495) on a structured grid.

    Inactive elements (`active_el` false) contribute nothing but still read
    bounds back from their neighbours, which is how a new element is
    activated (remhos_tools.cpp:475-487).

    The JAX function builds the [E, (p+1)^dim] arrays axis by axis; here the
    class-major stencil `overlap_stencil_T` is expanded by `cls[nd]`, the
    bounds class of each dof (ops/tables.py): the same minima and maxima of
    the same values, so the result is bit-identical. `masks` and `cls` are
    the caller's cached `edge_masks(shape)` and class table on the device;
    without them they are built here. The JAX function's
    shard-exchange arguments (`last_axis_exchange`, `last_axis_edges`,
    `axis_exchanges`) are not ported: the port runs on one device."""
    if active_el is not None:
        el_min = torch.where(active_el, el_min, INF)
        el_max = torch.where(active_el, el_max, -INF)
    if cls is None:
        from .ops.tables import class_of_dofs
        cls = torch.as_tensor(class_of_dofs((p + 1) ** len(shape),
                                            len(shape)),
                              dtype=torch.long, device=el_min.device)
    smin, smax = overlap_stencil_T(el_min, el_max, shape, periodic, masks)
    return smin[cls].T, smax[cls].T
