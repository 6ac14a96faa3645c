"""Static dof-topology tables of a structured mesh (host numpy).

The port's copy of the `remhos_tpu.dofmaps` subset the Cartesian remap path
uses: the element-local dofs on each face (`bdr_dofs`), the matching dof on
the face neighbour (`nbr_dof_local`) and the corner dofs of the p^dim
subcells (`sub2ind`). All elements of a structured grid share one
orientation, so the neighbour dof is the same tangential position on the
opposite face.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .mesh import faces_for_dim


def _lex_multi_index(n1: int, dim: int) -> np.ndarray:
    """[(n1)^dim, dim] multi-indices, x fastest."""
    grids = np.meshgrid(*[np.arange(n1)] * dim, indexing="ij")
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
    nbr_dof_local: np.ndarray    # [nfaces, fd] matching dof in the neighbour
    sub2ind: np.ndarray          # [p^dim, 2^dim] corner dofs of each subcell


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
