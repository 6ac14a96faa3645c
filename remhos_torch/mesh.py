"""Structured quad/hex meshes as dense host arrays.

The port's copy of the Cartesian subset of `remhos_tpu.mesh`: a grid of
`shape` elements per axis (element id = ix + nx*iy + nx*ny*iz), optional
periodicity, and per-element Gauss-Lobatto node coordinates x[E, nm, dim].
Face numbering follows MFEM's local face order.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .basis import gauss_lobatto

FACES_2D = ((1, 0), (0, 1), (1, 1), (0, 0))
FACES_3D = ((2, 0), (1, 0), (0, 1), (1, 1), (0, 0), (2, 1))


def faces_for_dim(dim: int):
    """Local faces as (axis, side), side 0 = low end, 1 = high end."""
    return {2: FACES_2D, 3: FACES_3D}[dim]


@dataclasses.dataclass(frozen=True)
class StructuredMesh:
    dim: int
    shape: tuple[int, ...]          # elements per axis
    lo: tuple[float, ...]
    hi: tuple[float, ...]
    periodic: tuple[bool, ...]
    mesh_order: int
    x: np.ndarray                   # [E, nm, dim] GLL node coordinates

    @property
    def num_elements(self) -> int:
        return int(np.prod(self.shape))

    @property
    def bb_min(self) -> np.ndarray:
        return np.asarray(self.lo)

    @property
    def bb_max(self) -> np.ndarray:
        return np.asarray(self.hi)


def make_cartesian_mesh(dim: int, shape: tuple[int, ...],
                        lo: tuple[float, ...], hi: tuple[float, ...],
                        periodic: tuple[bool, ...],
                        mesh_order: int = 2) -> StructuredMesh:
    if dim not in (2, 3):
        raise NotImplementedError(
            f"remhos_torch meshes are 2D or 3D, got dim={dim} "
            "(ROADMAP.md Queue 1, item 12)")
    breaks = [np.linspace(lo[d], hi[d], shape[d] + 1) for d in range(dim)]
    shape = tuple(int(s) for s in shape)
    E = int(np.prod(shape))
    gll = gauss_lobatto(mesh_order + 1)
    grids = np.meshgrid(*[np.arange(s) for s in shape], indexing="ij")
    eidx = np.stack([g.ravel(order="F") for g in grids], axis=-1)  # [E, dim]
    grids = np.meshgrid(*([gll] * dim), indexing="ij")
    ref = np.stack([g.ravel(order="F") for g in grids], axis=-1)   # [nm, dim]
    x = np.empty((E, len(ref), dim))
    for d in range(dim):
        b = breaks[d]
        los = b[eidx[:, d]]
        ws = b[eidx[:, d] + 1] - los
        x[:, :, d] = los[:, None] + ref[None, :, d] * ws[:, None]
    return StructuredMesh(dim, shape, tuple(float(b[0]) for b in breaks),
                          tuple(float(b[-1]) for b in breaks),
                          tuple(bool(p) for p in periodic), mesh_order, x)
