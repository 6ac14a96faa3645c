"""Structured-grid halos: the face-neighbour gather and the overlap-bounds
stencil as element-axis shifts (the `remhos_tpu.structured` subset on the
main path).

Grid layout: element e = ix + nx*iy + nx*ny*iz, so a step along mesh axis a
is a flat shift by stride_a = prod(shape[:a]); the grid view of u[E, nd] is
[n_last, ..., n_first, nd] (C order), mesh axis a is grid dimension
dim - 1 - a. A flat roll crosses the axis boundary on the edge rows; those
rows are patched: with 0 (gather) or +-inf (stencil) on a physical edge,
with the complementary wrap roll on a periodic axis, or, on a shard of a
sharded run, with the halo slab the neighbouring rank sent
(`parallel/sharded.py`).

Halo forms. `gather_nbr_structured(..., halo=)` and `face_rolls(...,
halo=)` take {face: slab}, each slab the grid's edge slice along the face's
axis (that grid dimension collapsed to 1, the face dofs trailing), already
masked by the caller (a neighbour's values, or the boundary values on a
physical edge). `overlap_stencil_flat` and `overlap_bounds_structured` take
`axis_exchanges` {mesh_axis: (exchange_fn, (has_prev, has_next))}:
exchange_fn(bot, top) -> (from_prev, from_next) swaps the edge slabs of the
PARTIALLY reduced work arrays after each axis pass (which carries the
corner contributions across shard corners), and the edges are Python
booleans; a missing neighbour reads +-inf. Each exchange_fn is a plain
callable, so one process can hold these functions against the JAX
package's with the same deterministic exchange on both sides.

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


def _grid_dim(dim, axis):
    return dim - 1 - axis


def _edge_index(arr_ndim, gdim, side):
    """The index of the (gdim, side) edge slice of a grid-shaped array,
    keeping the dimension (size 1)."""
    idx = [slice(None)] * arr_ndim
    idx[gdim] = slice(-1, None) if side == 1 else slice(0, 1)
    return tuple(idx)


def _shift(arr, gdim, side, periodic, fill=None, edge_slab=None):
    """Neighbour values along grid dimension `gdim` of a grid-shaped array:
    entry i reads i+1 (side 1) or i-1 (side 0). On a periodic axis the roll
    wraps; otherwise the edge slab reads `fill`, or `edge_slab` (given, it
    also overrides a periodic wrap)."""
    out = torch.roll(arr, -1 if side == 1 else 1, dims=gdim)
    if periodic and edge_slab is None:
        return out
    idx = _edge_index(arr.ndim, gdim, side)
    out[idx] = fill if edge_slab is None else edge_slab.reshape(
        out[idx].shape)
    return out


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


def face_rolls(face_vals, shape, periodic, bdr_value=None, halo=None):
    """Per-face neighbour blocks [E, fd] from grid-shaped face values:
    face_vals[f] is [*grid, fd], the element's own values at the dofs its
    neighbour across face f reads; each is shifted one element along f's
    grid dimension. Physical edges read 0, or bdr_value[:, f] (the inflow
    values of the element's own face dofs); a face in `halo` reads its
    slab on the edge instead (the JAX package's grid-shift form,
    remhos_tpu/structured.py:79)."""
    dim = len(shape)
    E = int(np.prod(shape))
    outs = []
    for f, (axis, side) in enumerate(faces_for_dim(dim)):
        gdim = _grid_dim(dim, axis)
        vals = face_vals[f]
        if halo is not None and f in halo:
            nb = _shift(vals, gdim, side, False,
                        edge_slab=halo[f]).reshape(E, -1)
        else:
            nb = _shift(vals, gdim, side, periodic[axis],
                        fill=0.0).reshape(E, -1)
            if not periodic[axis] and bdr_value is not None:
                edge = _edge_mask(E, shape, axis, side, vals.device)
                nb = torch.where(edge[:, None], bdr_value[:, f], nb)
        outs.append(nb)
    return outs


def _halo_patch_flat(slab, shape, axis, side):
    """A halo edge slab (the grid's edge slice along `axis`, trailing
    feature dimensions kept) as a flat [E, feat] array that is zero away
    from that edge: zeros concatenated along the grid dimension, then the
    free grid -> flat reshape, with no scatter."""
    gdim = _grid_dim(len(shape), axis)
    zshape = list(slab.shape)
    zshape[gdim] = shape[axis] - 1
    zeros = slab.new_zeros(zshape)
    full = torch.cat([slab, zeros] if side == 0 else [zeros, slab],
                     dim=gdim)
    return full.reshape(int(np.prod(shape)), -1)


def _flat_face_rolls(uf, shape, periodic, fd, masks, bdr_value=None,
                     halo=None):
    """Per-face neighbour blocks [E, fd] from the flat face trace
    uf[E, nf*fd] by element-axis rolls; physical edges read bdr_value[:, f]
    (the inflow values of the element's own face dofs), or 0 without it; a
    face in `halo` reads its slab on the edge rows (`_halo_patch_flat`)."""
    strides = _strides(shape)
    outs = []
    for f, (axis, side) in enumerate(faces_for_dim(len(shape))):
        dirn = 1 if side == 1 else -1
        blk = uf[:, f * fd:(f + 1) * fd]
        r1 = torch.roll(blk, -dirn * strides[axis], dims=0)
        edge = masks[(axis, side)][:, None]
        if halo is not None and f in halo:
            patch = _halo_patch_flat(halo[f], shape, axis, side)
            nb = torch.where(edge, patch, r1)
        elif periodic[axis]:
            wrap = -dirn * (shape[axis] - 1) * strides[axis]
            nb = torch.where(edge, torch.roll(blk, -wrap, dims=0), r1)
        elif bdr_value is not None:
            nb = torch.where(edge, bdr_value[:, f], r1)
        else:
            nb = torch.where(edge, 0.0, r1)
        outs.append(nb)
    return outs


def gather_nbr_structured(u, shape, periodic, nbr_dof_local, masks=None,
                          bdr_value=None, halo=None):
    """u_nbr[E, nf, fd]: each element's face-neighbour dof values, on
    physical boundaries bdr_value[E, nf, fd] or 0 (ExchangeFaceNbrData
    equivalent); `halo` {face: slab} overrides the edge of a sharded axis
    (see the module docstring). Exact in every dtype: an index gather plus
    element-axis rolls, no arithmetic. Column f*fd + i of the flat trace is
    the neighbour-side dof of face f's i-th face dof (the index form of the
    TPU's one-hot `_face_gather_matrix`)."""
    if masks is None:
        masks = edge_masks(shape, u.device)
    nbr = torch.as_tensor(nbr_dof_local, device=u.device, dtype=torch.long)
    fd = nbr.shape[1]
    uf = u.index_select(1, nbr.reshape(-1))
    return torch.stack(_flat_face_rolls(uf, shape, periodic, fd, masks,
                                        bdr_value, halo), dim=1)


def _exchanged_slabs(exch, Wmin, Wmax, grid_shape, gdim):
    """((min from prev, min from next), (max ...)) of one axis pass: the
    edge slabs of the partially reduced work arrays [E, c] swapped through
    exchange_fn and masked by the edges (+-inf where no neighbour)."""
    exchange_fn, (has_prev, has_next) = exch
    out = []
    for W, worst in ((Wmin, INF), (Wmax, -INF)):
        Wg = W.reshape(grid_shape + (W.shape[1],))
        bot = Wg[_edge_index(Wg.ndim, gdim, 0)].contiguous()
        top = Wg[_edge_index(Wg.ndim, gdim, 1)].contiguous()
        fp, fn = exchange_fn(bot, top)
        out.append((fp if has_prev else torch.full_like(bot, worst),
                    fn if has_next else torch.full_like(top, worst)))
    return out


def overlap_stencil_flat(el_min, el_max, shape, periodic, axis_exchanges=None,
                         masks=None):
    """The element-class overlap stencil (min, max), each [E, 3^dim]
    ELEMENT-major (column cz*9 + cy*3 + cx), by flat element-axis rolls of
    the partially reduced [E, c] arrays (c = 1 -> 3 -> 9 -> 27): the
    transpose of `overlap_stencil_T`, bit for bit (min and max only). With
    `axis_exchanges` (module docstring) each sharded axis's edge rows read
    the slabs the neighbours sent; the shard's local mesh is non-periodic
    along that axis. This is what kernel 1's "E" variant reads on a sharded
    grid (remhos_tpu/structured.py:212)."""
    if masks is None:
        masks = edge_masks(shape, el_min.device)
    dim = len(shape)
    grid_shape = tuple(reversed(shape))
    strides = _strides(shape)
    Wmin, Wmax = el_min[:, None], el_max[:, None]
    for axis in range(dim):
        s, n = strides[axis], shape[axis]
        exch = (axis_exchanges or {}).get(axis)
        slabs = (None if exch is None else _exchanged_slabs(
            exch, Wmin, Wmax, grid_shape, _grid_dim(dim, axis)))
        segs_min, segs_max = [Wmin], [Wmax]
        for side in (0, 1):
            dirn = 1 if side == 1 else -1
            edge = masks[(axis, side)][:, None]
            nmin = torch.roll(Wmin, -dirn * s, dims=0)
            nmax = torch.roll(Wmax, -dirn * s, dims=0)
            if slabs is not None:
                nmin = torch.where(edge, _halo_patch_flat(
                    slabs[0][side], shape, axis, side), nmin)
                nmax = torch.where(edge, _halo_patch_flat(
                    slabs[1][side], shape, axis, side), nmax)
            elif periodic[axis]:
                wrap = dirn * (n - 1) * s
                nmin = torch.where(edge, torch.roll(Wmin, wrap, dims=0), nmin)
                nmax = torch.where(edge, torch.roll(Wmax, wrap, dims=0), nmax)
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
        # the new class is the slowest: column cz*9 + cy*3 + cx
        Wmin = torch.cat(segs_min, dim=1)
        Wmax = torch.cat(segs_max, dim=1)
    return Wmin, Wmax


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
                              active_el=None, masks=None, cls=None,
                              axis_exchanges=None):
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
    without them they are built here.

    On a shard, `axis_exchanges` (module docstring) patches the sharded
    axes' edges, through the element-major `overlap_stencil_flat`."""
    if active_el is not None:
        el_min = torch.where(active_el, el_min, INF)
        el_max = torch.where(active_el, el_max, -INF)
    if cls is None:
        from .ops.tables import class_of_dofs
        cls = torch.as_tensor(class_of_dofs((p + 1) ** len(shape),
                                            len(shape)),
                              dtype=torch.long, device=el_min.device)
    if axis_exchanges:
        smin, smax = overlap_stencil_flat(el_min, el_max, shape, periodic,
                                          axis_exchanges, masks)
        return smin[:, cls], smax[:, cls]
    smin, smax = overlap_stencil_T(el_min, el_max, shape, periodic, masks)
    return smin[cls].T, smax[cls].T
