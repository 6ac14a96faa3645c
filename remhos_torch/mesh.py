"""Structured segment/quad/hex meshes as dense host arrays (numpy only).

The port's copy of the structured part of `remhos_tpu.mesh`: a grid of
`shape` elements per axis (element id = ix + nx*iy + nx*ny*iz) given by its
per-axis break points, optional periodicity, per-element Gauss-Lobatto node
coordinates x[E, nm, dim], midpoint refinement, the registry of the
reference's structured mesh files and the weak-scaling `default_mesh`
factory. Face numbering follows MFEM's local face order (a segment's faces:
left, right). `load_mesh` hands any other mesh file to the general loader
(`umesh.load_general_mesh`).
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

from .basis import gauss_lobatto

FACES_1D = ((0, 0), (0, 1))
FACES_2D = ((1, 0), (0, 1), (1, 1), (0, 0))
FACES_3D = ((2, 0), (1, 0), (0, 1), (1, 1), (0, 0), (2, 1))


def faces_for_dim(dim: int):
    """Local faces as (axis, side), side 0 = low end, 1 = high end."""
    return {1: FACES_1D, 2: FACES_2D, 3: FACES_3D}[dim]


@dataclasses.dataclass(frozen=True)
class StructuredMesh:
    """`breaks` holds the exact per-axis element boundaries. The
    reference's mesh files store truncated decimals (periodic-cube.mesh has
    six-digit -0.333333 interior vertices), and parity with it needs those
    exact values, so breaks, not (lo, hi, shape), define the geometry."""

    dim: int
    shape: tuple[int, ...]          # elements per axis
    lo: tuple[float, ...]
    hi: tuple[float, ...]
    periodic: tuple[bool, ...]
    mesh_order: int
    x: np.ndarray                   # [E, nm, dim] GLL node coordinates
    breaks: tuple = None            # per-axis element boundary coordinates

    @property
    def num_elements(self) -> int:
        return int(np.prod(self.shape))

    @property
    def bb_min(self) -> np.ndarray:
        return np.asarray(self.lo)

    @property
    def bb_max(self) -> np.ndarray:
        return np.asarray(self.hi)

    def refine(self, levels: int = 1) -> "StructuredMesh":
        """Uniform refinement: midpoint insertion per axis (MFEM's
        Mesh::UniformRefinement of a tensor mesh)."""
        m = self
        for _ in range(levels):
            m = make_mesh_from_breaks(
                m.dim, tuple(_refine_breaks(b) for b in m.breaks),
                m.periodic, m.mesh_order)
        return m

    def element_sizes(self) -> np.ndarray:
        """[E] element size (product of widths)^(1/dim): MFEM's
        GetElementSize type 0 on a tensor grid."""
        grids = np.meshgrid(*[np.diff(b) for b in self.breaks],
                            indexing="ij")
        vol = np.ones_like(grids[0])
        for g in grids:
            vol = vol * g
        return vol.ravel(order="F") ** (1.0 / self.dim)

    def element_centers(self) -> np.ndarray:
        """[E, dim] element centers."""
        cs = [0.5 * (b[:-1] + b[1:]) for b in self.breaks]
        grids = np.meshgrid(*cs, indexing="ij")
        return np.stack([g.ravel(order="F") for g in grids], axis=-1)


def _refine_breaks(b: np.ndarray) -> np.ndarray:
    out = np.empty(2 * len(b) - 1)
    out[0::2] = b
    out[1::2] = 0.5 * (b[:-1] + b[1:])
    return out


def make_mesh_from_breaks(dim: int, breaks: tuple,
                          periodic: tuple[bool, ...],
                          mesh_order: int = 2) -> StructuredMesh:
    breaks = tuple(np.asarray(b, dtype=np.float64) for b in breaks)
    shape = tuple(len(b) - 1 for b in breaks)
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
                          tuple(bool(p) for p in periodic), mesh_order, x,
                          breaks)


def make_cartesian_mesh(dim: int, shape: tuple[int, ...],
                        lo: tuple[float, ...], hi: tuple[float, ...],
                        periodic: tuple[bool, ...],
                        mesh_order: int = 2) -> StructuredMesh:
    breaks = tuple(np.linspace(lo[d], hi[d], int(shape[d]) + 1)
                   for d in range(dim))
    return make_mesh_from_breaks(dim, breaks, periodic, mesh_order)


# The reference's structured mesh files, by their geometry. The per-axis
# break points reproduce the EXACT coordinates stored in those files
# (truncated decimals and all).
_T9 = 0.333333333      # periodic-square.mesh interior vertex (9 digits)
_T6 = 0.333333         # periodic-cube.mesh interior vertex (6 digits)
_REGISTRY = {
    # inline-quad.mesh: 4x4 quads on [0,1]^2, non-periodic
    "inline-quad": dict(dim=2, breaks=([0, 0.25, 0.5, 0.75, 1],) * 2,
                        periodic=(False, False)),
    # periodic-square.mesh: 3x3 quads on [-1,1]^2, fully periodic
    "periodic-square": dict(dim=2, breaks=([-1, -_T9, _T9, 1],) * 2,
                            periodic=(True, True)),
    # periodic-cube.mesh: 3x3x3 hexes on [-1,1]^3, fully periodic
    "periodic-cube": dict(dim=3, breaks=([-1, -_T6, _T6, 1],) * 3,
                          periodic=(True, True, True)),
    # cube01_hex.mesh: 2x2x2 hexes on [0,1]^3, non-periodic
    "cube01_hex": dict(dim=3, breaks=([0, 0.5, 1],) * 3,
                       periodic=(False, False, False)),
    # periodic-segment.mesh: 4 segments on [0,1], periodic
    "periodic-segment": dict(dim=1, breaks=([0, 0.25, 0.5, 0.75, 1],),
                             periodic=(True,)),
}


def _registry_key(name: str) -> str:
    key = name[:-len(".mesh")] if name.endswith(".mesh") else name
    return key.split("/")[-1]


def registry_dim(name: str):
    """The dimension of a registry mesh (by name, with or without a path
    and `.mesh`), or None for any other mesh file."""
    spec = _REGISTRY.get(_registry_key(name))
    return None if spec is None else spec["dim"]


def find_mesh_file(name: str):
    """The path of a mesh file that is not in the registry, as the JAX
    package searches it: `name` as a path, then `<key>.mesh` under
    $REMHOS_REF_DATA; None when neither exists."""
    candidates = [name]
    data_dir = os.environ.get("REMHOS_REF_DATA")
    if data_dir:
        candidates.append(os.path.join(data_dir,
                                       _registry_key(name) + ".mesh"))
    for c in candidates:
        if os.path.isfile(c):
            return c
    return None


def load_mesh(name: str, rs_levels: int = 0, mesh_order: int = 2):
    """A registry mesh by name (with or without a path and `.mesh`), or any
    other MFEM mesh file through the general loader (`umesh.py`: quads,
    hexes, curved H1 and NURBS meshes), plus serial refinements
    (remhos.cpp:448-449). Raises FileNotFoundError when a name is neither
    in the registry nor a file (`find_mesh_file`)."""
    key = _registry_key(name)
    if key not in _REGISTRY:
        path = find_mesh_file(name)
        if path is None:
            raise FileNotFoundError(
                f"mesh '{name}': not a registry mesh {sorted(_REGISTRY)} "
                "and no such file (searched as a path, then as "
                f"'{key}.mesh' under $REMHOS_REF_DATA)")
        from .umesh import load_general_mesh
        return load_general_mesh(path, rs_levels, mesh_order)
    spec = _REGISTRY[key]
    m = make_mesh_from_breaks(spec["dim"], spec["breaks"], spec["periodic"],
                              mesh_order)
    return m.refine(rs_levels)


def default_mesh(dim: int, n_shards: int, elem_per_shard: int,
                 mesh_order: int = 2) -> StructuredMesh:
    """The weak-scaling mesh factory: a unit box of exactly
    n_shards*elem_per_shard elements in `dim` near-equal axes, the last
    taking what the others leave (PartitionMPI, remhos.cpp:453)."""
    axes = []
    rem = n_shards * elem_per_shard
    for d in range(dim - 1):
        a = max(1, round(rem ** (1.0 / (dim - d))))
        while rem % a != 0:
            a -= 1
        axes.append(a)
        rem //= a
    axes.append(rem)
    return make_cartesian_mesh(dim, tuple(axes), (0.0,) * dim, (1.0,) * dim,
                               (False,) * dim, mesh_order)
