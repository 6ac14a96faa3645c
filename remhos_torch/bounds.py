"""Per-dof admissible bounds for the FCT limiters: the port of
`remhos_tpu.bounds` (the DofInfo bounds machinery, remhos_tools.cpp:381-523).

- element min/max over the Bernstein dofs, which bound the field;
- the overlap stencil (`-bt 0`): element extrema scattered onto the shared
  Gauss-Lobatto CG nodes, min/max there, gathered back. Structured meshes
  take the separable pass of `structured.overlap_bounds_structured`
  instead; `overlap_bounds` serves every other mesh;
- the sparsity stencil (`-bt 1`): the extrema of the element and its face
  neighbours.

`active_el` / `active_dof` masks support product-field remap, where empty
elements must not affect the bounds (remhos.cpp:1889-1892)."""

from __future__ import annotations

import torch

INF = float("inf")


def elements_min_max(u, active_el=None, active_dof=None):
    """(el_min[E], el_max[E]) over each element's Bernstein dofs, which
    bound the element's polynomial. Inactive dofs and elements read +inf
    (min) and -inf (max)."""
    lo, hi = u, u
    if active_dof is not None:
        lo = torch.where(active_dof, u, INF)
        hi = torch.where(active_dof, u, -INF)
    el_min, el_max = lo.amin(dim=1), hi.amax(dim=1)
    if active_el is not None:
        el_min = torch.where(active_el, el_min, INF)
        el_max = torch.where(active_el, el_max, -INF)
    return el_min, el_max


def overlap_cg_minmax(el_min, el_max, cg_idx, n_cg, active_el=None):
    """The element extrema scattered onto the shared CG (Gauss-Lobatto)
    node grid: (x_min[n_cg], x_max[n_cg]). cg_idx[E, nd] (long) holds each
    DG dof's CG node. amin/amax into +inf/-inf buffers: deterministic."""
    E, nd = cg_idx.shape
    src_min = el_min[:, None].expand(E, nd)
    src_max = el_max[:, None].expand(E, nd)
    if active_el is not None:
        src_min = torch.where(active_el[:, None], src_min, INF)
        src_max = torch.where(active_el[:, None], src_max, -INF)
    flat = cg_idx.reshape(-1)
    x_min = torch.full((n_cg,), INF, dtype=el_min.dtype,
                       device=el_min.device)
    x_max = torch.full((n_cg,), -INF, dtype=el_max.dtype,
                       device=el_max.device)
    x_min.scatter_reduce_(0, flat, src_min.reshape(-1), "amin",
                          include_self=True)
    x_max.scatter_reduce_(0, flat, src_max.reshape(-1), "amax",
                          include_self=True)
    return x_min, x_max


def overlap_bounds(el_min, el_max, cg_idx, n_cg, active_el=None):
    """(dof_min[E, nd], dof_max[E, nd]) from the overlapping-elements
    stencil (ComputeOverlapBounds, remhos_tools.cpp:432-495). Inactive
    elements do not contribute but still read bounds back (the activation
    of new elements, remhos_tools.cpp:475-487)."""
    x_min, x_max = overlap_cg_minmax(el_min, el_max, cg_idx, n_cg, active_el)
    return x_min[cg_idx], x_max[cg_idx]


def sparsity_bounds(el_min, el_max, nbr_elem, nd):
    """(dof_min[E, nd], dof_max[E, nd]) from the face-neighbour elements
    only (ComputeMatrixSparsityBounds, remhos_tools.cpp:381-430): one value
    per element, broadcast over its dofs as an expanded view (stride 0);
    a kernel that reads them takes `.contiguous()` copies. nbr_elem[E, nf]
    (long) is -1 on physical boundaries."""
    valid = nbr_elem >= 0
    safe = nbr_elem.clamp(min=0)
    nmin = torch.where(valid, el_min[safe], INF)          # [E, nf]
    nmax = torch.where(valid, el_max[safe], -INF)
    lo = torch.minimum(el_min, nmin.amin(dim=1))
    hi = torch.maximum(el_max, nmax.amax(dim=1))
    E = el_min.shape[0]
    return lo[:, None].expand(E, nd), hi[:, None].expand(E, nd)


def compute_bounds(el_min, el_max, topo, bounds_type: int, active_el=None):
    """Per-dof bounds as DofInfo::ComputeBounds dispatches
    (remhos_tools.hpp:168-188): `-bt 0` the overlap stencil, otherwise the
    sparsity stencil (which ignores `active_el`, as the reference does).
    topo: a `dofmaps.BoundsTopology`."""
    if bounds_type == 0:
        return overlap_bounds(el_min, el_max, topo.cg_idx, topo.n_cg,
                              active_el=active_el)
    return sparsity_bounds(el_min, el_max, topo.nbr_elem, topo.nd)
