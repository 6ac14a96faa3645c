"""General (unstructured) 3D hex meshes with orientation-aware topology: the
port of `remhos_tpu.umesh3d` (host numpy).

The 3D analogue of umesh.py: conforming hex meshes whose elements may meet
in any of the 8 relative face orientations (each element's frame is any of
the 24 rotations of the cube). The reference handles this with explicit
orientation cases (GetLocalFaceDofIndex3D, remhos_tools.cpp:1078-1329);
here the face-dof correspondence comes from the matched vertex quads: for
two elements sharing a face, the affine map between their tangential index
frames is rebuilt from where the four corner vertices land, and applied to
all (p+1)^2 face dofs. The same construction numbers the oriented edges and
faces of the global Gauss-Lobatto CG (bounds) space.

MFEM's hex vertex order (v0..v7: the bottom quad ccw, then the top quad
aligned) maps to lex corners as [v0, v1, v3, v2, v4, v5, v7, v6].
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .basis import gauss_lobatto
from .dofmaps import DofMaps, _lex_multi_index, face_dof_table
from .mesh import FACES_3D
from .umesh import _first_seen_numbering, _pair_ids

# face corner grids in LEX corner numbering (c = ix + 2*iy + 4*iz):
# T[j][i] with (i, j) the tangential axes in increasing mesh-axis order
_FACE_CORNERS = {
    (2, 0): [[0, 1], [2, 3]],   # z- : (x, y)
    (2, 1): [[4, 5], [6, 7]],
    (1, 0): [[0, 1], [4, 5]],   # y- : (x, z)
    (1, 1): [[2, 3], [6, 7]],
    (0, 0): [[0, 2], [4, 6]],   # x- : (y, z)
    (0, 1): [[1, 3], [5, 7]],
}


@dataclasses.dataclass(frozen=True)
class GeneralMesh3D:
    dim: int
    mesh_order: int
    x: np.ndarray            # [E, nm, 3]
    corners: np.ndarray      # [E, 8] vertex ids, lex order
    corner_pos: np.ndarray   # [E, 8, 3]
    nbr_elem: np.ndarray     # [E, 6]
    nbr_face: np.ndarray     # [E, 6]
    nbr_map: np.ndarray      # [E, 6, 6] affine tangential map
    #                          (a_i, b_ii, b_ij, a_j, b_ji, b_jj)
    lo: tuple
    hi: tuple

    structured = False
    periodic = (False, False, False)
    nfaces = 6

    @property
    def num_elements(self):
        return self.x.shape[0]

    @property
    def bb_min(self):
        return np.asarray(self.lo)

    @property
    def bb_max(self):
        return np.asarray(self.hi)

    def element_sizes(self):
        """|det J|^(1/3) of the trilinear corner map at the centre."""
        c = self.corner_pos

        def d(axis_bit):
            hi = [k for k in range(8) if (k >> axis_bit) & 1]
            lo = [k for k in range(8) if not (k >> axis_bit) & 1]
            return 0.25 * (c[:, hi].sum(1) - c[:, lo].sum(1))
        J = np.stack([d(0), d(1), d(2)], axis=-1)
        return np.abs(np.linalg.det(J)) ** (1.0 / 3.0)

    def element_centers(self):
        return self.corner_pos.mean(axis=1)

    def refine(self, levels: int = 1):
        m = self
        for _ in range(levels):
            m = _refine_hex(m)
        return m


def _face_transform(A, B):
    """The affine map (i, j) -> (i2, j2) over {0,1}^2 with A[j][i] ==
    B[j2][i2], as (a_i, b_ii, b_ij, a_j, b_ji, b_jj):
    i2 = a_i + b_ii*i + b_ij*j, j2 = a_j + b_ji*i + b_jj*j."""
    pos = {int(B[j][i]): (i, j) for j in range(2) for i in range(2)}
    i0, j0 = pos[int(A[0][0])]
    i_di, j_di = pos[int(A[0][1])]      # a step along my i
    i_dj, j_dj = pos[int(A[1][0])]      # a step along my j
    return (i0, i_di - i0, i_dj - i0, j0, j_di - j0, j_dj - j0)


def from_arrays_3d(corners, corner_pos, mesh_order=2, x_nodes=None):
    """A GeneralMesh3D from lex-ordered corner ids and positions; x_nodes
    overrides the (trilinear) geometry nodes."""
    corners = np.asarray(corners, np.int64)
    corner_pos = np.asarray(corner_pos, np.float64)
    E = corners.shape[0]
    nbr_elem = np.full((E, 6), -1, np.int32)
    nbr_face = np.full((E, 6), -1, np.int32)
    nbr_map = np.zeros((E, 6, 6), np.int32)
    fmap = {}
    fc = [_FACE_CORNERS[f] for f in FACES_3D]
    cl = corners.tolist()
    for e in range(E):
        ce = cl[e]
        for f in range(6):
            (a, b), (c, d) = fc[f]
            quad = [[ce[a], ce[b]], [ce[c], ce[d]]]
            key = frozenset((ce[a], ce[b], ce[c], ce[d]))
            if key in fmap:
                e2, f2, quad2 = fmap.pop(key)
                nbr_elem[e, f], nbr_face[e, f] = e2, f2
                nbr_elem[e2, f2], nbr_face[e2, f2] = e, f
                nbr_map[e, f] = _face_transform(quad, quad2)
                nbr_map[e2, f2] = _face_transform(quad2, quad)
            else:
                fmap[key] = (e, f, quad)
    if x_nodes is not None:
        x = np.asarray(x_nodes, np.float64)
    else:
        # trilinear corner interpolation at the GLL tensor points
        gll = gauss_lobatto(mesh_order + 1)
        xi = [g.ravel(order="F")
              for g in np.meshgrid(gll, gll, gll, indexing="ij")]
        w = np.ones((len(xi[0]), 8))
        for c in range(8):
            for a in range(3):
                w[:, c] *= xi[a] if (c >> a) & 1 else (1.0 - xi[a])
        x = np.einsum("nc,ecd->end", w, corner_pos)
    return GeneralMesh3D(3, mesh_order, x, corners, corner_pos, nbr_elem,
                         nbr_face, nbr_map,
                         tuple(x.reshape(-1, 3).min(axis=0)),
                         tuple(x.reshape(-1, 3).max(axis=0)))


def _refine_hex(m: GeneralMesh3D):
    """Uniform refinement into 8 children: the new vertices are shared ids
    keyed by the parent corners they touch (edge midpoints, face and cell
    centres); the children's geometry is trilinear in their corners, as the
    JAX package builds it."""
    next_vid = int(m.corners.max()) + 1
    table = {}

    def node_id(vids):
        nonlocal next_vid
        key = tuple(sorted(vids))
        if key not in table:
            table[key] = next_vid
            next_vid += 1
        return table[key]

    sub = _lex_multi_index(2, 3)         # 8 children, lex
    kid_corners = [[s + corner for corner in sub] for s in sub]
    new_c, new_p = [], []
    for e in range(m.num_elements):
        c = [int(v) for v in m.corners[e]]
        p = m.corner_pos[e]
        for kc in kid_corners:
            ids, pos = [], []
            for q in kc:        # half-grid coordinates 0..2 of the corner
                axes = [[v // 2] if v in (0, 2) else [0, 1] for v in q]
                touch = [bx + 2 * by + 4 * bz for bx in axes[0]
                         for by in axes[1] for bz in axes[2]]
                ids.append(c[touch[0]] if len(touch) == 1
                           else node_id([c[t] for t in touch]))
                acc = np.zeros(3)
                for t in touch:
                    acc += p[t]
                pos.append(acc / len(touch))
            new_c.append(ids)
            new_p.append(pos)
    return from_arrays_3d(np.asarray(new_c), np.asarray(new_p), m.mesh_order)


def build_general_dofmaps_3d(mesh: GeneralMesh3D, p: int) -> DofMaps:
    """The DofMaps of a general hex mesh: the neighbour dof table
    nbr_dof_local[E, 6, fd] through each face's orientation map, and the
    global GLL CG node ids (vertex / oriented edge / oriented face /
    interior, numbered in first-seen order)."""
    n1 = p + 1
    fd = n1 * n1
    bdr = face_dof_table(p, 3)                            # [6, fd]
    E = mesh.num_elements

    # ---- the neighbour dof table through the orientation maps ----
    tidx = _lex_multi_index(n1, 2)                        # (i, j), i fastest
    f2 = np.asarray(mesh.nbr_face)
    mp = np.asarray(mesh.nbr_map, np.int64)[..., None]    # [E, 6, 6, 1]
    i2 = mp[:, :, 0] * p + mp[:, :, 1] * tidx[:, 0] + mp[:, :, 2] * tidx[:, 1]
    j2 = mp[:, :, 3] * p + mp[:, :, 4] * tidx[:, 0] + mp[:, :, 5] * tidx[:, 1]
    own = np.broadcast_to(np.arange(6)[None, :], f2.shape)
    bnd = (f2 < 0)[..., None]
    nbr_dof = np.where(bnd, bdr[own], bdr[np.maximum(f2, 0)[..., None],
                                          np.where(bnd, 0, i2 + n1 * j2)])
    nbr_dof = nbr_dof.astype(np.int32)

    # ---- global CG (GLL, order q = max(p, 1)) node numbering ----
    q = max(p, 1)
    midx = _lex_multi_index(q + 1, 3)
    ndb = len(midx)
    c = np.asarray(mesh.corners, np.int64)
    n_vert = int(c.max()) + 1
    kind = np.zeros((E, ndb), np.int64)   # 0 vertex, 1 edge, 2 face, 3 int.
    key = np.zeros((E, ndb), np.int64)
    off = np.zeros((E, ndb), np.int64)
    edges, edge_at, faces, face_at = [], [], [], []
    for jn in range(ndb):
        coords = [int(v) for v in midx[jn]]
        on = [v in (0, q) for v in coords]
        if all(on):
            key[:, jn] = c[:, sum((v // q) << a for a, v in enumerate(coords))]
        elif sum(on) == 2:
            # on an edge: the free axis runs from lo to hi
            free = on.index(False)
            lo = sum(((coords[a] // q) if a != free else 0) << a
                     for a in range(3))
            hi = lo + (1 << free)
            va, vb = c[:, lo], c[:, hi]
            k = coords[free] - 1
            kind[:, jn] = 1
            off[:, jn] = np.where(va < vb, k, q - 2 - k)
            edges.append((va, vb))
            edge_at.append(jn)
        elif sum(on) == 1:
            # on a face: the fixed axis; canonical frame anchored at the
            # face's smallest vertex, s toward its smaller face neighbour
            fixed = on.index(True)
            T = _FACE_CORNERS[(fixed, coords[fixed] // q)]
            quad = np.stack([c[:, T[0][0]], c[:, T[0][1]],
                             c[:, T[1][0]], c[:, T[1][1]]], 1)   # [E, 4]
            tang = [a for a in range(3) if a != fixed]
            i, j = coords[tang[0]], coords[tang[1]]
            at = quad.argmin(axis=1)
            ia, ja = at % 2, at // 2
            nb1 = quad[np.arange(E), ja * 2 + (1 - ia)]     # a step along i
            nb2 = quad[np.arange(E), (1 - ja) * 2 + ia]     # a step along j
            di, dj = i - ia * q, j - ja * q
            si, sj = (1 - 2 * ia) * di, (1 - 2 * ja) * dj
            s = np.where(nb1 < nb2, si, sj)
            t = np.where(nb1 < nb2, sj, si)
            kind[:, jn] = 2
            off[:, jn] = (s - 1) + (q - 1) * (t - 1)
            faces.append(np.sort(quad, axis=1))
            face_at.append(jn)
        else:
            kind[:, jn] = 3
    n_edge = n_face = 0
    if edge_at:
        key[:, edge_at] = _pair_ids(np.stack([a for a, _ in edges], 1),
                                    np.stack([b for _, b in edges], 1))
        n_edge = int(key[:, edge_at].max()) + 1
    if face_at:
        fkeys = np.stack(faces, 1).reshape(-1, 4)
        key[:, face_at] = np.unique(fkeys, axis=0, return_inverse=True)[
            1].reshape(E, len(face_at))
        n_face = int(key[:, face_at].max()) + 1
    ent = np.select(
        [kind == 0, kind == 1, kind == 2],
        [key, n_vert + key, n_vert + n_edge + key],
        n_vert + n_edge + n_face + np.arange(E * ndb).reshape(E, ndb))
    size = np.concatenate([np.ones(n_vert, np.int64),
                           np.full(n_edge, q - 1, np.int64),
                           np.full(n_face, (q - 1) ** 2, np.int64),
                           np.ones(E * ndb, np.int64)])
    base, n_cg = _first_seen_numbering(ent.reshape(-1), size)
    cg_idx = (base.reshape(E, ndb) + off).astype(np.int32)

    # subcell corners; p = 0 keeps the JAX package's one degenerate row
    sidx = (_lex_multi_index(p, 3) if p >= 1
            else np.zeros((1, 3), np.int64))
    sub2ind = (((sidx[:, None, :] + _lex_multi_index(2, 3)[None, :, :])
                * n1 ** np.arange(3)).sum(-1).astype(np.int32))
    return DofMaps(p, 3, n1 ** 3, fd, 6, bdr, nbr_dof, sub2ind,
                   nbr_elem=np.asarray(mesh.nbr_elem), cg_idx=cg_idx,
                   n_cg=n_cg)
