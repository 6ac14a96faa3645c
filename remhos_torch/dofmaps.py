"""Static dof-topology tables (host numpy): the port of
`remhos_tpu.dofmaps`.

The element-local dofs on each face (`bdr_dofs`), the matching dof on the
face neighbour (`nbr_dof_local`) and the corner dofs of the p^dim subcells
(`sub2ind`). All elements of a structured grid share one orientation, so
there the neighbour dof is the same tangential position on the opposite
face, one [nfaces, fd] table for every element. A general mesh
(`umesh.build_general_dofmaps`, `umesh3d.build_general_dofmaps_3d`) has a
table per element and face, [E, nfaces, fd], and carries its face
neighbours and global CG nodes in the DofMaps. `bounds_topology` gives the
bounds stencils those mesh-wide tables on a device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .mesh import faces_for_dim


def _lex_multi_index(n1: int, dim: int) -> np.ndarray:
    """[(n1)^dim, dim] multi-indices, x fastest."""
    return _grid_multi_index((n1,) * dim)


def _grid_multi_index(shape) -> np.ndarray:
    """[prod(shape), dim] multi-indices of a grid, x fastest."""
    grids = np.meshgrid(*[np.arange(s) for s in shape], indexing="ij")
    return np.stack([g.ravel(order="F") for g in grids], axis=-1)


def face_dof_table(p: int, dim: int) -> np.ndarray:
    """bdr_dofs[nfaces, (p+1)^(dim-1)]: local dofs on each face, lex order
    in the face-tangential axes."""
    n1 = p + 1
    midx = _lex_multi_index(n1, dim)
    faces = faces_for_dim(dim)
    out = np.empty((len(faces), n1 ** (dim - 1)), dtype=np.int32)
    for f, (axis, side) in enumerate(faces):
        sel = np.where(midx[:, axis] == (0 if side == 0 else p))[0]
        key = np.zeros(len(sel), dtype=np.int64)
        mult = 1
        for a in range(dim):
            if a != axis:
                key += midx[sel, a] * mult
                mult *= n1
        out[f] = sel[np.argsort(key, kind="stable")]
    return out


def opposite_face(dim: int) -> np.ndarray:
    """opp[f] = local index of the same-axis face on the other side."""
    faces = faces_for_dim(dim)
    return np.array([faces.index((axis, 1 - side)) for axis, side in faces],
                    dtype=np.int32)


@dataclasses.dataclass(frozen=True)
class DofMaps:
    p: int
    dim: int
    nd: int                      # dofs per element
    fd: int                      # dofs per face
    nfaces: int
    bdr_dofs: np.ndarray         # [nfaces, fd] local dof ids on each face
    nbr_dof_local: np.ndarray    # [nfaces, fd] (structured) or
    #                              [E, nfaces, fd] (general) matching dof in
    #                              the neighbour
    sub2ind: np.ndarray          # [p^dim, 2^dim] corner dofs of each subcell
    # general meshes only: face neighbours (-1 on a physical boundary), the
    # global CG (GLL) node of each dof and their count
    nbr_elem: np.ndarray = None  # [E, nfaces]
    cg_idx: np.ndarray = None    # [E, nd]
    n_cg: int = 0


def build_dofmaps(dim: int, p: int) -> DofMaps:
    n1 = p + 1
    bdr = face_dof_table(p, dim)
    # subcell corner map (FillSubcell2CellDof, remhos_tools.cpp:678-734):
    # subcell origins and corner offsets, both lexicographic, x fastest
    strides = n1 ** np.arange(dim)
    sub2ind = ((_lex_multi_index(p, dim)[:, None, :]
                + _lex_multi_index(2, dim)[None, :, :]) * strides).sum(-1)
    return DofMaps(p, dim, n1 ** dim, n1 ** (dim - 1), 2 * dim, bdr,
                   bdr[opposite_face(dim)], sub2ind.astype(np.int32))


@dataclasses.dataclass(frozen=True)
class BoundsTopology:
    """The tables `bounds.compute_bounds` reads, as long tensors on one
    device."""

    nd: int
    nbr_elem: torch.Tensor       # [E, nfaces] neighbour elements, -1 = bdr
    cg_idx: torch.Tensor         # [E, nd] global CG (GLL) node of each dof
    n_cg: int


def neighbour_elements(shape, periodic) -> np.ndarray:
    """nbr_elem[E, nfaces]: the face neighbour of each element across each
    local face, -1 on a physical boundary (the JAX package's mesh table)."""
    dim = len(shape)
    E = int(np.prod(shape))
    eidx = _grid_multi_index(shape)
    strides = np.cumprod((1,) + tuple(shape[:-1]))
    nbr = np.empty((E, 2 * dim), dtype=np.int64)
    for f, (axis, side) in enumerate(faces_for_dim(dim)):
        tgt = eidx[:, axis] + (1 if side == 1 else -1)
        if periodic[axis]:
            valid = np.ones(E, dtype=bool)
            tgt = np.mod(tgt, shape[axis])
        else:
            valid = (tgt >= 0) & (tgt < shape[axis])
            tgt = np.clip(tgt, 0, shape[axis] - 1)
        nbr[:, f] = np.where(
            valid, eidx @ strides + (tgt - eidx[:, axis]) * strides[axis], -1)
    return nbr


def cg_node_ids(shape, periodic, p: int):
    """(cg_idx[E, nd], n_cg): the global Gauss-Lobatto CG node of order
    max(p, 1) of each DG dof, periodic axes wrapped (the overlap stencil's
    scatter/gather, remhos_tools.cpp:432-495)."""
    dim = len(shape)
    q = max(p, 1)
    midx = _lex_multi_index(q + 1, dim)
    gshape = tuple(q * s if per else q * s + 1
                   for s, per in zip(shape, periodic))
    gstrides = np.cumprod((1,) + gshape[:-1])
    g = q * _grid_multi_index(shape)[:, None, :] + midx[None, :, :]
    for d in range(dim):
        if periodic[d]:
            g[:, :, d] %= gshape[d]
    return (g * gstrides).sum(-1), int(np.prod(gshape))


def bounds_topology(mesh, p: int, device, dofmaps=None) -> BoundsTopology:
    """The bounds tables of a mesh at order p on `device`: computed for a
    structured mesh, read from its `dofmaps` (at order p) for a general
    one."""
    def L(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.long,
                               device=device)

    nd = (p + 1) ** mesh.dim
    if not getattr(mesh, "structured", True):
        if dofmaps is None or dofmaps.cg_idx is None or dofmaps.p != p:
            raise ValueError("a general mesh's bounds tables come from its "
                             f"DofMaps at order {p}")
        return BoundsTopology(nd, L(dofmaps.nbr_elem), L(dofmaps.cg_idx),
                              dofmaps.n_cg)
    cg_idx, n_cg = cg_node_ids(mesh.shape, mesh.periodic, p)
    return BoundsTopology(nd, L(neighbour_elements(mesh.shape,
                                                   mesh.periodic)),
                          L(cg_idx), n_cg)
