"""General (unstructured) quad meshes with gather-based face topology: the
port of `remhos_tpu.umesh` (host numpy).

Arbitrary conforming quad meshes (the reference's periodic-hexagon.mesh and
unstr.mesh scenarios, remhos.cpp:448). Every compute path reads the
per-element node coordinates x[E, nm, dim]; this module builds the
topology tables:

- neighbour element/face pairs by matching face vertex sets;
- per-(element, face) neighbour dof maps with the tangential orientation
  (the 2D reversed-traversal rule of FillNeighborDofs,
  remhos_tools.cpp:590-625);
- global Gauss-Lobatto CG node ids for the overlap bounds (vertex /
  oriented edge / interior), numbered in the order the JAX package's
  element-by-element loop first meets them;
- uniform refinement (topology from shared edge-midpoint ids, geometry by
  evaluating each parent's map at the children's nodes, so a periodic wrap
  and curved elements carry over).

MFEM's quad vertex order (v0, v1, v2, v3) is counterclockwise; the tensor
(lexicographic) corner order used here is [v0, v1, v3, v2].
`load_general_mesh` reads MFEM files: the H1 "Quadratic" and "Cubic" node
files, NURBS files (`nurbs.py`) and v1.0 files with vertices or L2 nodes
in 2D and 3D (`native/`, `umesh3d.py`).
"""

from __future__ import annotations

import dataclasses
import re

import numpy as np

from .basis import (gauss_lobatto, lagrange_grads, lagrange_vals,
                    tensor_mixed, tensor_mixed_grads)
from .dofmaps import DofMaps, _lex_multi_index, face_dof_table

# faces as ordered corner pairs in the direction of increasing tangential
# coordinate, in LEX corner numbering (c0=(0,0), c1=(1,0), c2=(0,1),
# c3=(1,1)): y-, x+, y+, x- (mesh.FACES_2D)
_QUAD_FACES_LEX = ((0, 1), (1, 3), (2, 3), (0, 2))


@dataclasses.dataclass(frozen=True)
class GeneralMesh:
    dim: int
    mesh_order: int
    x: np.ndarray            # [E, nm, dim] geometry nodes (GLL tensor)
    corners: np.ndarray      # [E, 2^dim] vertex ids, LEX corner order
    corner_pos: np.ndarray   # [E, 2^dim, dim] corner positions (per elem)
    nbr_elem: np.ndarray     # [E, nf]
    nbr_face: np.ndarray     # [E, nf] neighbour's local face (-1: boundary)
    nbr_flip: np.ndarray     # [E, nf] tangential order reversed?
    lo: tuple
    hi: tuple

    structured = False
    periodic = (False, False)   # boundary handling is per face

    @property
    def num_elements(self) -> int:
        return self.x.shape[0]

    @property
    def nfaces(self) -> int:
        return 2 * self.dim

    @property
    def bb_min(self):
        return np.asarray(self.lo)

    @property
    def bb_max(self):
        return np.asarray(self.hi)

    def element_sizes(self) -> np.ndarray:
        """sqrt |det J| of the (curved) geometry at the reference centre
        (GetElementSize type 0)."""
        gll = gauss_lobatto(self.mesh_order + 1)
        c = np.array([0.5])
        Bv, Gv = lagrange_vals(gll, c), lagrange_grads(gll, c)
        G = tensor_mixed_grads([Bv, Bv], [Gv, Gv])[0]      # [nm, 2]
        J = np.einsum("end,nb->edb", self.x, G)
        det = J[:, 0, 0] * J[:, 1, 1] - J[:, 0, 1] * J[:, 1, 0]
        return np.sqrt(np.abs(det))

    def element_centers(self) -> np.ndarray:
        """The geometry map at the reference centre (curved-aware)."""
        gll = gauss_lobatto(self.mesh_order + 1)
        B = tensor_mixed([lagrange_vals(gll, np.array([0.5]))] * 2)
        return np.einsum("end,n->ed", self.x, B[0])

    def refine(self, levels: int = 1) -> "GeneralMesh":
        m = self
        for _ in range(levels):
            m = _refine_quad(m)
        return m


def from_arrays(corners, corner_pos, mesh_order=2,
                x_nodes=None) -> GeneralMesh:
    """A GeneralMesh from lex-ordered corner ids and positions (2D).
    x_nodes overrides the geometry nodes (curved or NURBS elements)."""
    E = corners.shape[0]
    nbr_elem = np.full((E, 4), -1, np.int32)
    nbr_face = np.full((E, 4), -1, np.int32)
    nbr_flip = np.zeros((E, 4), bool)
    face_map = {}
    for e in range(E):
        for f, (a, b) in enumerate(_QUAD_FACES_LEX):
            va, vb = int(corners[e, a]), int(corners[e, b])
            key = (min(va, vb), max(va, vb))
            if key in face_map:
                e2, f2, (va2, vb2) = face_map.pop(key)
                nbr_elem[e, f], nbr_face[e, f] = e2, f2
                nbr_elem[e2, f2], nbr_face[e2, f2] = e, f
                # traversed in OPPOSITE directions, dof j matches the
                # neighbour's fd-1-j; in the SAME direction, j matches j
                flip = not (va == va2 and vb == vb2)
                nbr_flip[e, f] = nbr_flip[e2, f2] = flip
            else:
                face_map[key] = (e, f, (va, vb))
    gll = gauss_lobatto(mesh_order + 1)
    if x_nodes is not None:
        x = np.asarray(x_nodes, np.float64)
    else:
        # bilinear corner interpolation at the GLL tensor points
        xi, eta = np.meshgrid(gll, gll, indexing="ij")
        xi, eta = xi.ravel(order="F"), eta.ravel(order="F")
        w = np.stack([(1 - xi) * (1 - eta), xi * (1 - eta),
                      (1 - xi) * eta, xi * eta], axis=-1)   # [nm, 4] lex
        x = np.einsum("nc,ecd->end", w, corner_pos)
    # the bounding box sampled MFEM-style on a reference lattice that holds
    # the nodes (GetBoundingBox(max(order, 1)), remhos.cpp:457)
    B = tensor_mixed([lagrange_vals(gll, np.linspace(0.0, 1.0, 4))] * 2)
    pts = np.einsum("qn,end->eqd", B, x).reshape(-1, 2)
    return GeneralMesh(2, mesh_order, x, corners.astype(np.int64),
                       corner_pos, nbr_elem, nbr_face, nbr_flip,
                       tuple(pts.min(axis=0)), tuple(pts.max(axis=0)))


def _refine_quad(m: GeneralMesh) -> GeneralMesh:
    """Uniform refinement: topology from shared edge-midpoint ids; geometry
    by evaluating each parent's (possibly curved) Q-k map at the children's
    nodes (exact for polynomial geometry, and periodic-safe)."""
    mo = m.mesh_order
    n1 = mo + 1
    gll = gauss_lobatto(n1)
    child_tabs = [tensor_mixed([lagrange_vals(gll, sx / 2 + gll / 2),
                                lagrange_vals(gll, sy / 2 + gll / 2)])
                  for sy in (0, 1) for sx in (0, 1)]        # [nm, nm] each
    next_vid = int(m.corners.max()) + 1
    edge_mid = {}

    def mid_id(va, vb):
        nonlocal next_vid
        key = (min(va, vb), max(va, vb))
        if key not in edge_mid:
            edge_mid[key] = next_vid
            next_vid += 1
        return edge_mid[key]

    new_corners, new_pos, new_x = [], [], []
    for e in range(m.num_elements):
        c = [int(v) for v in m.corners[e]]
        m01, m23 = mid_id(c[0], c[1]), mid_id(c[2], c[3])
        m02, m13 = mid_id(c[0], c[2]), mid_id(c[1], c[3])
        ctr = next_vid
        next_vid += 1
        # the children in the 2x2 lex layout (x fastest), as child_tabs
        kids = [[c[0], m01, m02, ctr], [m01, c[1], ctr, m13],
                [m02, ctr, c[2], m23], [ctr, m13, m23, c[3]]]
        for tab, kc in zip(child_tabs, kids):
            kx = tab @ m.x[e]                              # [nm, dim]
            new_corners.append(kc)
            new_x.append(kx)
            new_pos.append([kx[0], kx[n1 - 1], kx[n1 * (n1 - 1)],
                            kx[n1 * n1 - 1]])
    return from_arrays(np.asarray(new_corners, np.int64),
                       np.asarray(new_pos, np.float64), mo,
                       x_nodes=np.asarray(new_x))


def load_h1_nodes_mesh(path: str, order: int, rs_levels: int = 0
                       ) -> GeneralMesh:
    """A 2D quad mesh with an H1 nodes grid function of the given order
    (star-q2 "Quadratic", star-q3 "Cubic").

    MFEM's H1 dof layout (fespace.cpp GetElementDofs): the vertices, then
    the first-seen edges with order-1 dofs each, stored along the edge's
    canonical (min -> max vertex id) direction, then (order-1)^2 interior
    dofs per element, lex (x fastest) in the element frame. The nodes are
    Gauss-Lobatto (H1_FECollection's default basis), as from_arrays'
    x_nodes."""
    with open(path) as fh:
        tok = re.sub(r"#[^\n]*", " ", fh.read()).split()
    i = tok.index("elements") + 1
    ne = int(tok[i])
    i += 1
    elems = []
    for _ in range(ne):
        i += 2
        elems.append([int(tok[i + k]) for k in range(4)])
        i += 4
    i = tok.index("vertices", i) + 1
    nv = int(tok[i])
    i += 1
    edge_id = {}                      # first-seen, MFEM local edge order
    for ev in elems:
        for a, b in ((ev[0], ev[1]), (ev[1], ev[2]), (ev[2], ev[3]),
                     (ev[3], ev[0])):
            edge_id.setdefault((min(a, b), max(a, b)), len(edge_id))
    nedge = len(edge_id)
    i = tok.index("Ordering:", i) + 1
    ordering = int(tok[i])
    i += 1
    ned = order - 1                   # dofs per edge
    nid = ned * ned                   # interior dofs per element
    ndof = nv + ned * nedge + nid * ne
    vals = np.array([float(t) for t in tok[i:i + 2 * ndof]])
    nodes = (np.stack([vals[:ndof], vals[ndof:]], axis=1) if ordering == 0
             else vals.reshape(ndof, 2))

    n1 = order + 1
    x = np.zeros((ne, n1 * n1, 2))
    corners = np.zeros((ne, 4), np.int64)

    def lat(ix, iy):                  # lex lattice index, x fastest
        return iy * n1 + ix

    def edge_dofs(a, b):
        """The edge's dof ids walking a -> b (stored min -> max)."""
        d = nv + ned * edge_id[(min(a, b), max(a, b))] + np.arange(ned)
        return d if a < b else d[::-1]

    for e, ev in enumerate(elems):
        ids = np.zeros(n1 * n1, np.int64)
        # corners: MFEM ccw (v0, v1, v2, v3) -> lattice corners
        ids[lat(0, 0)], ids[lat(n1 - 1, 0)] = ev[0], ev[1]
        ids[lat(n1 - 1, n1 - 1)], ids[lat(0, n1 - 1)] = ev[2], ev[3]
        # the local edges at their lattice positions, in local direction
        for k, d in enumerate(edge_dofs(ev[0], ev[1])):
            ids[lat(1 + k, 0)] = d                       # bottom, +x
        for k, d in enumerate(edge_dofs(ev[1], ev[2])):
            ids[lat(n1 - 1, 1 + k)] = d                  # right, +y
        for k, d in enumerate(edge_dofs(ev[2], ev[3])):
            ids[lat(n1 - 2 - k, n1 - 1)] = d             # top, -x
        for k, d in enumerate(edge_dofs(ev[3], ev[0])):
            ids[lat(0, n1 - 2 - k)] = d                  # left, -y
        base = nv + ned * nedge + nid * e                # interior, lex
        for jy in range(ned):
            for jx in range(ned):
                ids[lat(1 + jx, 1 + jy)] = base + jy * ned + jx
        x[e] = nodes[ids]
        corners[e] = [ev[0], ev[1], ev[3], ev[2]]
    cp = x[:, [0, n1 - 1, n1 * (n1 - 1), n1 * n1 - 1]]
    return from_arrays(corners, cp, order, x_nodes=x).refine(rs_levels)


def _lattice_corner_ids(n1: int, dim: int):
    """The lex lattice indices of an element's 2^dim corners, lex order."""
    c2 = [0, n1 - 1, n1 * (n1 - 1), n1 * n1 - 1]
    return c2 if dim == 2 else c2 + [c + n1 * n1 * (n1 - 1) for c in c2]


def load_general_mesh(path: str, rs_levels: int = 0, mesh_order: int = 2):
    """Load an MFEM .mesh file: H1 "Quadratic"/"Cubic" node files and NURBS
    files in Python, v1.0 files with vertices or L2 nodes (2D quads, 3D
    hexes) through the native parser (which raises when it cannot be
    built)."""
    with open(path) as fh:
        header = fh.readline()
        dim_line = fh.read(400)
        body = header + dim_line + fh.read()
    if "FiniteElementCollection: Quadratic" in body:
        return load_h1_nodes_mesh(path, 2, rs_levels)
    if "FiniteElementCollection: Cubic" in body:
        return load_h1_nodes_mesh(path, 3, rs_levels)
    if "NURBS" in header:
        from . import nurbs
        if "dimension\n3" in dim_line.replace(" ", ""):
            return nurbs.load_nurbs_mesh_3d(path, rs_levels, mesh_order)
        return nurbs.load_nurbs_mesh(path, rs_levels, mesh_order)
    from .native import load_mfem_mesh

    parsed = load_mfem_mesh(path)
    if parsed["kind"] != "v10" or parsed["dim"] not in (2, 3):
        raise ValueError(f"{path}: the general loader reads MFEM v1.0 quad "
                         "and hex meshes (got a "
                         f"{parsed['kind']} mesh of dim {parsed['dim']})")
    dim = parsed["dim"]
    ev = parsed["elem_verts"]
    # MFEM's vertex order -> lex corner order
    corners = (ev[:, [0, 1, 3, 2, 4, 5, 7, 6]] if dim == 3
               else ev[:, [0, 1, 3, 2]]).astype(np.int64)
    if dim == 3:
        from .umesh3d import from_arrays_3d as build
    else:
        build = from_arrays
    if "l2_nodes" in parsed:
        # per-element GLL-lattice nodes (periodic, curved or written by
        # vis.py); order 1 nodes give straight elements at mesh_order
        k = parsed["l2_order"]
        xn = np.asarray(parsed["l2_nodes"], np.float64)
        corner_pos = xn[:, _lattice_corner_ids(k + 1, dim)]
        m = build(corners, corner_pos, k if k > 1 else mesh_order,
                  x_nodes=xn if k > 1 else None)
    else:
        m = build(corners, np.asarray(parsed["verts"][corners], np.float64),
                  mesh_order)
    return m.refine(rs_levels)


def _first_seen_numbering(ent, size):
    """Global node ids of entity-local nodes numbered as an
    element-by-element loop allocates them: each entity gets `size[ent]`
    consecutive ids when it is first met in the flat order of `ent`.
    ent[n] (int): the entity of each visited node; returns (base[ent] of
    each, the total count)."""
    uniq, first = np.unique(ent, return_index=True)
    order = np.argsort(first, kind="stable")
    sizes = size[uniq[order]]
    base = np.zeros(len(uniq), np.int64)
    base[order] = np.cumsum(sizes) - sizes
    return base[np.searchsorted(uniq, ent)], int(sizes.sum())


def _pair_ids(a, b):
    """Dense ids of unordered vertex pairs (a, b), equal for equal pairs."""
    lo, hi = np.minimum(a, b), np.maximum(a, b)
    return np.unique(np.stack([lo, hi], -1).reshape(-1, 2), axis=0,
                     return_inverse=True)[1].reshape(a.shape)


def build_general_dofmaps(mesh: GeneralMesh, p: int) -> DofMaps:
    """The DofMaps of a general 2D quad mesh: the per-(e, f) neighbour dof
    table nbr_dof_local[E, 4, fd] and the global GLL CG node ids (vertex /
    oriented edge / interior, numbered in first-seen order)."""
    n1 = p + 1
    fd = n1
    bdr = face_dof_table(p, 2)                           # [4, fd]
    E = mesh.num_elements
    f2 = np.asarray(mesh.nbr_face)
    own = np.broadcast_to(np.arange(4)[None, :], f2.shape)
    rows = np.where((f2 < 0)[..., None], bdr[own],
                    np.where(mesh.nbr_flip[..., None], bdr[:, ::-1][f2],
                             bdr[f2]))
    nbr_dof = rows.astype(np.int32)

    # CG (GLL) global ids of order q = max(p, 1), classified per lattice node
    q = max(p, 1)
    midx = _lex_multi_index(q + 1, 2)
    ndb = len(midx)
    c = np.asarray(mesh.corners, np.int64)
    n_vert = int(c.max()) + 1
    kind = np.zeros((E, ndb), np.int64)      # 0 vertex, 1 edge, 2 interior
    key = np.zeros((E, ndb), np.int64)
    off = np.zeros((E, ndb), np.int64)
    edge_a, edge_b, edge_k, edge_at = [], [], [], []
    corner_of = {(0, 0): 0, (q, 0): 1, (0, q): 2, (q, q): 3}
    for j in range(ndb):
        i0, i1 = int(midx[j, 0]), int(midx[j, 1])
        onx, ony = i0 in (0, q), i1 in (0, q)
        if onx and ony:
            key[:, j] = c[:, corner_of[(i0, i1)]]
        elif ony or onx:
            a, b = _QUAD_FACES_LEX[(0 if i1 == 0 else 2) if ony
                                   else (3 if i0 == 0 else 1)]
            k = (i0 if ony else i1) - 1
            va, vb = c[:, a], c[:, b]
            kind[:, j] = 1
            off[:, j] = np.where(va < vb, k, q - 2 - k)  # canonical direction
            edge_a.append(va)
            edge_b.append(vb)
            edge_at.append(j)
        else:
            kind[:, j] = 2
    if edge_at:
        eid = _pair_ids(np.stack(edge_a, 1), np.stack(edge_b, 1))
        key[:, edge_at] = eid
    n_edge = int(key[kind == 1].max()) + 1 if edge_at else 0
    # entity ids: vertices, then edges, then one per interior node
    ent = np.where(kind == 0, key, np.where(
        kind == 1, n_vert + key,
        n_vert + n_edge + np.arange(E * ndb).reshape(E, ndb)))
    size = np.concatenate([np.ones(n_vert, np.int64),
                           np.full(n_edge, q - 1, np.int64),
                           np.ones(E * ndb, np.int64)])
    base, n_cg = _first_seen_numbering(ent.reshape(-1), size)
    cg_idx = (base.reshape(E, ndb) + off).astype(np.int32)

    # subcell corners; p = 0 keeps the JAX package's one degenerate row
    sidx = (_lex_multi_index(p, 2) if p >= 1
            else np.zeros((1, 2), np.int64))
    sub2ind = (((sidx[:, None, :] + _lex_multi_index(2, 2)[None, :, :])
                * n1 ** np.arange(2)).sum(-1).astype(np.int32))
    return DofMaps(p, 2, n1 * n1, fd, 4, bdr, nbr_dof, sub2ind,
                   nbr_elem=np.asarray(mesh.nbr_elem), cg_idx=cg_idx,
                   n_cg=n_cg)
