"""NURBS meshes as per-element rational Bezier patches: the port of
`remhos_tpu.nurbs` (host numpy).

The reference loads MFEM NURBS meshes (disc-nurbs.mesh, ball-nurbs.mesh),
refines them uniformly by knot insertion, and SetCurvature(2) then replaces
the NURBS geometry with its Q2 Gauss-Lobatto nodal interpolant
(remhos.cpp:448-449, 513). The net geometric content: the (refined) NURBS
map evaluated at each element's GLL points.

The meshes in use are single-knot-span patches, i.e. rational Bernstein
(Bezier) patches, so refinement by knot insertion gives the same element
geometry as de Casteljau subdivision of the homogeneous control nets
(Bezier extraction), which is what this module does:

- parse "MFEM NURBS mesh v1.0" with Bezier knot vectors (2D and 3D);
- assemble per-element homogeneous control nets from MFEM's NURBS dof
  numbering (vertices, then edge dofs by edge id, then faces in 3D, then
  patch interiors);
- refine: a 2^dim de Casteljau split per level, with the shared vertex ids
  of the topology;
- evaluate at the GLL tensor points -> a general mesh (`umesh.py`,
  `umesh3d.py`).
"""

from __future__ import annotations

import re

import numpy as np

from .basis import bernstein_vals, gauss_lobatto
from .dofmaps import _lex_multi_index
from .umesh import GeneralMesh, from_arrays


def _tokens(path):
    with open(path) as fh:
        return re.sub(r"#[^\n]*", " ", fh.read()).split()


class _Reader:
    """A cursor over a NURBS file's tokens."""

    def __init__(self, path):
        self.tok = _tokens(path)
        self.i = 0

    def seek(self, word):
        while self.tok[self.i] != word:
            self.i += 1
        self.i += 1

    def ints(self, n):
        v = [int(t) for t in self.tok[self.i:self.i + n]]
        self.i += n
        return v

    def floats(self, n):
        v = [float(t) for t in self.tok[self.i:self.i + n]]
        self.i += n
        return v

    def skip(self, n):
        self.i += n


def _knot_orders(r):
    """The orders of the knot vectors; each must be a single Bezier span."""
    r.seek("knotvectors")
    orders = []
    for _ in range(r.ints(1)[0]):
        p, ncp = r.ints(2)
        knots = r.floats(ncp + p + 1)
        if not (ncp == p + 1 and set(knots) == {0.0, 1.0}):
            raise ValueError("only single-span (Bezier) knot vectors are "
                             "supported")
        orders.append(p)
    if any(o != orders[0] for o in orders):
        raise ValueError("NURBS knot vectors of mixed orders")
    return orders[0]


def parse_nurbs_mesh(path: str):
    """Parse the 2D MFEM NURBS format into (elems, edges, nv, weights, cps,
    order). Only single-span (Bezier) knot vectors are supported."""
    r = _Reader(path)
    r.seek("dimension")
    if r.ints(1)[0] != 2:
        raise ValueError(f"{path}: parse_nurbs_mesh reads 2D meshes")
    r.seek("elements")
    elems = []
    for _ in range(r.ints(1)[0]):
        _, geom = r.ints(2)
        if geom != 3:
            raise ValueError(f"{path}: a 2D NURBS element must be a square")
        elems.append(r.ints(4))
    r.seek("boundary")
    for _ in range(r.ints(1)[0]):
        _, geom = r.ints(2)
        r.skip(2 if geom == 1 else 4)
    r.seek("edges")
    edges = [tuple(r.ints(3)) for _ in range(r.ints(1)[0])]
    r.seek("vertices")
    nv = r.ints(1)[0]
    p = _knot_orders(r)
    ndof = nv + len(edges) * (p - 1) + len(elems) * (p - 1) ** 2
    r.seek("weights")
    weights = np.array(r.floats(ndof))
    r.seek("Ordering:")
    r.skip(1)
    cps = np.array(r.floats(ndof * 2), dtype=np.float64).reshape(ndof, 2)
    return elems, edges, nv, weights, cps, p


def control_nets(path: str):
    """Per-element homogeneous control nets H[E, n, n, 3] (wx, wy, w) in
    (xi, eta) index order, and the lex corner vertex ids [E, 4]."""
    elems, edges, nv, w, cps, p = parse_nurbs_mesh(path)
    n = p + 1
    edge_dof = {}
    for idx, (_, v0, v1) in enumerate(edges):
        a, b = (v0, v1) if v0 < v1 else (v1, v0)
        edge_dof[(a, b)] = (nv + idx * (p - 1), +1)
        edge_dof[(b, a)] = (nv + idx * (p - 1) + p - 2, -1)
    E = len(elems)
    H = np.zeros((E, n, n, 3))
    corners_lex = np.zeros((E, 4), np.int64)
    hom = np.concatenate([cps * w[:, None], w[:, None]], axis=1)  # [ndof, 3]
    int_base = nv + len(edges) * (p - 1)
    ii, jj = np.meshgrid(range(p - 1), range(p - 1), indexing="ij")
    for e, (v0, v1, v2, v3) in enumerate(elems):
        # net[i, j]: i along xi (v0 -> v1), j along eta (v0 -> v3)
        net_ids = np.zeros((n, n), np.int64)
        net_ids[0, 0], net_ids[-1, 0] = v0, v1
        net_ids[-1, -1], net_ids[0, -1] = v2, v3
        for (a, b), sl in (((v0, v1), (slice(1, n - 1), 0)),
                           ((v3, v2), (slice(1, n - 1), n - 1)),
                           ((v0, v3), (0, slice(1, n - 1))),
                           ((v1, v2), (n - 1, slice(1, n - 1)))):
            base, step = edge_dof[(a, b)]
            net_ids[sl] = base + step * np.arange(p - 1)
        net_ids[1:n - 1, 1:n - 1] = (int_base + e * (p - 1) * (p - 1)
                                     + (jj * (p - 1) + ii))
        H[e] = hom[net_ids]
        corners_lex[e] = [v0, v1, v3, v2]
    return H, corners_lex


def _decasteljau_split(H, axis):
    """Split Bezier nets in half along `axis` (control points of any order
    p along it): H[..., n, ..., c] -> (left, right)."""
    Hm = np.moveaxis(H, axis, -2)
    pts = [Hm]
    while pts[-1].shape[-2] > 1:
        P = pts[-1]
        pts.append(0.5 * (P[..., :-1, :] + P[..., 1:, :]))
    left = np.concatenate([q[..., :1, :] for q in pts], axis=-2)
    right = np.concatenate([q[..., -1:, :] for q in reversed(pts)], axis=-2)
    return np.moveaxis(left, -2, axis), np.moveaxis(right, -2, axis)


def _shared_ids(start):
    """A table of new vertex ids keyed by the sorted parent vertices they
    lie between, allocated from `start` in first-seen order."""
    table = {}
    nxt = [start]

    def node_id(vids):
        key = tuple(sorted(int(v) for v in vids))
        if key not in table:
            table[key] = nxt[0]
            nxt[0] += 1
        return table[key]

    def fresh():
        nxt[0] += 1
        return nxt[0] - 1

    return node_id, fresh


def load_nurbs_mesh(path: str, rs_levels: int = 0,
                    mesh_order: int = 2) -> GeneralMesh:
    """A 2D NURBS mesh refined rs_levels times, at the GLL points of
    mesh_order."""
    H, corners = control_nets(path)
    for _ in range(rs_levels):
        # the topology ids exactly as umesh._refine_quad makes them
        mid_id, fresh = _shared_ids(int(corners.max()) + 1)
        new_H, new_corners = [], []
        for e in range(H.shape[0]):
            c = [int(v) for v in corners[e]]
            m01, m23 = mid_id((c[0], c[1])), mid_id((c[2], c[3]))
            m02, m13 = mid_id((c[0], c[2])), mid_id((c[1], c[3]))
            ctr = fresh()
            lo_x, hi_x = _decasteljau_split(H[e], axis=0)
            quads = [_decasteljau_split(part, axis=1)
                     for part in (lo_x, hi_x)]
            # the children in the 2x2 lex layout (x fastest)
            for kh, kc in ((quads[0][0], [c[0], m01, m02, ctr]),
                           (quads[1][0], [m01, c[1], ctr, m13]),
                           (quads[0][1], [m02, ctr, c[2], m23]),
                           (quads[1][1], [ctr, m13, m23, c[3]])):
                new_H.append(kh)
                new_corners.append(kc)
        H = np.stack(new_H)
        corners = np.asarray(new_corners, np.int64)

    n = H.shape[1]
    B = bernstein_vals(n - 1, gauss_lobatto(mesh_order + 1))   # [m1, n]
    hx = np.einsum("ai,bj,eijc->eabc", B, B, H)      # [E, m1, m1, 3]
    x = hx[..., :2] / hx[..., 2:3]
    m1 = mesh_order + 1
    # lex node order: x fastest = xi fastest
    x = x.transpose(0, 2, 1, 3).reshape(H.shape[0], m1 * m1, 2, order="C")
    corner_pos = np.stack([x[:, 0], x[:, m1 - 1], x[:, m1 * (m1 - 1)],
                           x[:, m1 * m1 - 1]], axis=1)
    return from_arrays(corners, corner_pos, mesh_order, x_nodes=x)


# ---------------------------------------------------------------------------
# 3D (hex) NURBS: ball-nurbs-style Bezier patches
# ---------------------------------------------------------------------------

# MFEM's hex local faces (vertex sequences, outward ccw; mfem geom.cpp); the
# faces are numbered on first encounter in this order
_MFEM_HEX_FACES = [(3, 2, 1, 0), (0, 1, 5, 4), (1, 2, 6, 5),
                   (2, 3, 7, 6), (3, 0, 4, 7), (4, 5, 6, 7)]


def parse_nurbs_mesh_3d(path: str):
    """Parse the 3D MFEM NURBS format into (elems, edges, nv, face_id,
    face_frame, weights, cps, order)."""
    r = _Reader(path)
    r.seek("dimension")
    if r.ints(1)[0] != 3:
        raise ValueError(f"{path}: parse_nurbs_mesh_3d reads 3D meshes")
    r.seek("elements")
    elems = []
    for _ in range(r.ints(1)[0]):
        r.skip(2)                        # attribute, geometry (5)
        elems.append(r.ints(8))
    r.seek("boundary")
    for _ in range(r.ints(1)[0]):
        r.skip(6)                        # attribute, geometry (3), 4 ids
    r.seek("edges")
    edges = []
    for _ in range(r.ints(1)[0]):
        _, v0, v1 = r.ints(3)
        edges.append((v0, v1))
    r.seek("vertices")
    nv = r.ints(1)[0]
    p = _knot_orders(r)

    # faces in MFEM's order: elements in order, local faces 0..5; the FIRST
    # encounter stores the face's vertex frame (its dofs run s: q0 -> q1,
    # t: q0 -> q3)
    face_id, face_frame = {}, []
    for ev in elems:
        for lf in _MFEM_HEX_FACES:
            quad = tuple(ev[k] for k in lf)
            key = frozenset(quad)
            if key not in face_id:
                face_id[key] = len(face_frame)
                face_frame.append(quad)
    npe = p - 1
    ndof = (nv + len(edges) * npe + len(face_frame) * npe * npe
            + len(elems) * npe ** 3)
    r.seek("weights")
    weights = np.array(r.floats(ndof))
    if r.tok[r.i] != "FiniteElementSpace":
        raise ValueError(f"{path}: NURBS dof count mismatch (got token "
                         f"{r.tok[r.i]!r})")
    r.seek("Ordering:")
    r.skip(1)
    cps = np.array(r.floats(ndof * 3), dtype=np.float64).reshape(ndof, 3)
    return elems, edges, nv, face_id, face_frame, weights, cps, p


def control_nets_3d(path: str, face_layout: str = "s-fast"):
    """H[E, n, n, n, 4] homogeneous nets (wx, wy, wz, w), index (xi, eta,
    zeta), and corners_lex[E, 8]. face_layout: the fast index of the stored
    face dofs ("s-fast": along q0 -> q1; "t-fast": along q0 -> q3)."""
    from .umesh3d import _FACE_CORNERS
    (elems, edges, nv, face_id, face_frame, w, cps,
     p) = parse_nurbs_mesh_3d(path)
    n = p + 1
    npe = p - 1
    # NURBS edge dofs run from the SMALLER to the LARGER vertex id, whatever
    # the order the edges section lists (the JAX package found this against
    # the exact sphere of ball-nurbs)
    edge_dof = {}
    for idx, (v0, v1) in enumerate(edges):
        a, b = (v0, v1) if v0 < v1 else (v1, v0)
        edge_dof[(a, b)] = (nv + idx * npe, +1)
        edge_dof[(b, a)] = (nv + idx * npe + npe - 1, -1)
    face_base = nv + len(edges) * npe
    int_base = face_base + len(face_frame) * npe * npe

    E = len(elems)
    H = np.zeros((E, n, n, n, 4))
    corners_lex = np.zeros((E, 8), np.int64)
    hom = np.concatenate([cps * w[:, None], w[:, None]], axis=1)
    mfem_of_lex = [0, 1, 3, 2, 4, 5, 7, 6]
    # the hex edges in lex terms: (corner a, corner b, axis)
    lex_edges = [(0, 1, 0), (2, 3, 0), (4, 5, 0), (6, 7, 0),
                 (0, 2, 1), (1, 3, 1), (4, 6, 1), (5, 7, 1),
                 (0, 4, 2), (1, 5, 2), (2, 6, 2), (3, 7, 2)]
    bits = [(k & 1, (k >> 1) & 1, (k >> 2) & 1) for k in range(8)]
    interior = slice(1, n - 1)
    ii, jj = np.meshgrid(np.arange(1, p), np.arange(1, p), indexing="ij")
    iii, jjj, kkk = np.meshgrid(np.arange(1, p), np.arange(1, p),
                                np.arange(1, p), indexing="ij")
    for e, ev in enumerate(elems):
        cl = [ev[k] for k in mfem_of_lex]        # lex corner vertex ids
        corners_lex[e] = cl
        ids = np.zeros((n, n, n), np.int64)
        for k, (bx, by, bz) in enumerate(bits):
            ids[bx * p, by * p, bz * p] = cl[k]
        for ca, cb, axis in lex_edges:
            base, step = edge_dof[(cl[ca], cl[cb])]
            sl = [bits[ca][0] * p, bits[ca][1] * p, bits[ca][2] * p]
            sl[axis] = interior
            ids[tuple(sl)] = base + step * np.arange(npe)
        for (axis, side), T in _FACE_CORNERS.items():
            # my face frame quad[j][i] (tangential axes t1 < t2), expressed
            # in the stored frame: s along q0 -> q1, t along q0 -> q3
            quad = [[cl[T[j][i]] for i in range(2)] for j in range(2)]
            fid = face_id[frozenset(quad[0] + quad[1])]
            frame = face_frame[fid]
            pos = {int(quad[j][i]): (i, j) for j in range(2)
                   for i in range(2)}
            i0, j0 = pos[frame[0]]
            is_, js_ = pos[frame[1]]                 # an s step
            it_, jt_ = pos[frame[3]]                 # a t step
            di, dj = ii - i0 * p, jj - j0 * p
            s = (is_ - i0) * di + (js_ - j0) * dj
            t = (it_ - i0) * di + (jt_ - j0) * dj
            if face_layout == "s-fast":
                vals = face_base + fid * npe * npe + (s - 1) + npe * (t - 1)
            else:
                vals = face_base + fid * npe * npe + (t - 1) + npe * (s - 1)
            tang = [a for a in range(3) if a != axis]
            full = [None, None, None]
            full[axis] = np.full((npe, npe), side * p)
            full[tang[0]] = ii
            full[tang[1]] = jj
            ids[full[0], full[1], full[2]] = vals
        ids[interior, interior, interior] = (
            int_base + e * npe ** 3
            + (iii - 1) + npe * (jjj - 1) + npe * npe * (kkk - 1))
        H[e] = hom[ids]
    return H, corners_lex


def load_nurbs_mesh_3d(path: str, rs_levels: int = 0, mesh_order: int = 2):
    """A 3D NURBS mesh refined rs_levels times, at the GLL points of
    mesh_order."""
    from .umesh3d import from_arrays_3d

    H, corners = control_nets_3d(path)
    sub = _lex_multi_index(2, 3)
    for _ in range(rs_levels):
        node_id, _ = _shared_ids(int(corners.max()) + 1)
        new_H, new_c = [], []
        for e in range(H.shape[0]):
            c = corners[e]

            def vid(q):
                axes = [[v // 2] if v in (0, 2) else [0, 1] for v in q]
                ids = [int(c[bx + 2 * by + 4 * bz])
                       for bx in axes[0] for by in axes[1] for bz in axes[2]]
                return ids[0] if len(ids) == 1 else node_id(ids)

            parts = {}
            for sx, px in zip((0, 1), _decasteljau_split(H[e], axis=0)):
                for sy, py in zip((0, 1), _decasteljau_split(px, axis=1)):
                    lo2, hi2 = _decasteljau_split(py, axis=2)
                    parts[(sx, sy, 0)], parts[(sx, sy, 1)] = lo2, hi2
            for s in sub:
                new_H.append(parts[tuple(s)])
                new_c.append([vid(tuple(s + corner)) for corner in sub])
        H = np.stack(new_H)
        corners = np.asarray(new_c, np.int64)

    n = H.shape[1]
    B = bernstein_vals(n - 1, gauss_lobatto(mesh_order + 1))
    hx = np.einsum("ai,bj,ck,eijkd->eabcd", B, B, B, H)
    x = hx[..., :3] / hx[..., 3:4]
    m1 = mesh_order + 1
    # lex node order (xi fastest): (a, b, c) -> (c, b, a), then reshape
    x = x.transpose(0, 3, 2, 1, 4).reshape(H.shape[0], m1 ** 3, 3)
    c2 = [0, m1 - 1, m1 * (m1 - 1), m1 * m1 - 1]
    corner_pos = x[:, c2 + [c + m1 * m1 * (m1 - 1) for c in c2]]
    return from_arrays_3d(corners, corner_pos, mesh_order, x_nodes=x)
