"""General meshes for the port's tests, built from arrays and written as
MFEM files (the reference's mesh files are not in the repository).

- `structured_corners`: the lexicographic corner ids and positions of a
  structured mesh's elements, the input of `from_arrays*`;
- `scramble_3d`: each hex's corner frame turned by one of the 24 cube
  rotations, from a seed (tests/test_umesh3d.py's `_scramble`);
- `mixed_start_2d`: each quad's corner cycle started at a vertex from a
  seed (a rotation of its frame by a multiple of 90 degrees);
- `write_h1_mesh`: an MFEM v1.0 file with an H1 "Quadratic" or "Cubic"
  nodes grid function (MFEM's H1 dof layout) of a perturbed grid;
- `write_nurbs_2d`, `write_nurbs_3d`: a one-patch degree-2 NURBS file with
  weights that are not 1;
- `write_general_meshes`: the general-mesh driver tests' three files;
  `run_both`: one configuration on both drivers, held to 1e-12.
"""

import itertools

import numpy as np

from remhos_tpu import driver as jdriver
from remhos_tpu.config import RunConfig as JConfig

from remhos_torch import driver, umesh, umesh3d, vis
from remhos_torch.basis import gauss_lobatto
from remhos_torch.config import RunConfig
from remhos_torch.mesh import load_mesh
from remhos_torch.vis import _structured_corner_ids


def structured_corners(mesh):
    """(corners[E, 2^dim], corner_pos[E, 2^dim, dim]) of a structured mesh,
    lexicographic corner order."""
    corners, _ = _structured_corner_ids(mesh)
    n1 = mesh.mesh_order + 1
    c2 = [0, n1 - 1, n1 * (n1 - 1), n1 * n1 - 1]
    ids = c2 if mesh.dim == 2 else c2 + [c + n1 * n1 * (n1 - 1) for c in c2]
    return corners, mesh.x[:, ids]


def rotations():
    """The 24 rotation matrices of the cube (axis permutations with signs,
    det = +1)."""
    rots = []
    for perm in itertools.permutations(range(3)):
        for signs in itertools.product((1, -1), repeat=3):
            R = np.zeros((3, 3))
            for a in range(3):
                R[a, perm[a]] = signs[a]
            if np.linalg.det(R) > 0:
                rots.append(R)
    return rots


def scramble_3d(corners, corner_pos, seed=0):
    """Each element's corner frame turned by a random cube rotation."""
    rng = np.random.default_rng(seed)
    rots = rotations()
    bits = np.stack([(np.arange(8) >> d) & 1 for d in range(3)], -1)
    ref = bits - 0.5
    new_c, new_p = np.empty_like(corners), np.empty_like(corner_pos)
    for e in range(len(corners)):
        R = rots[rng.integers(len(rots))]
        old_of_new = ((ref @ R.T) > 0).astype(int) @ np.array([1, 2, 4])
        new_c[e] = corners[e][old_of_new]
        new_p[e] = corner_pos[e][old_of_new]
    return new_c, new_p


def mixed_start_2d(corners, corner_pos, seed=0):
    """Each quad's ccw corner cycle started at a random vertex."""
    rng = np.random.default_rng(seed)
    ccw = [0, 1, 3, 2]                       # lex <-> MFEM ccw (involution)
    k = rng.integers(0, 4, len(corners))
    idx = ((np.arange(4)[None, :] + k[:, None]) % 4)
    c = np.take_along_axis(corners[:, ccw], idx, 1)[:, ccw]
    p = np.take_along_axis(corner_pos[:, ccw], idx[:, :, None], 1)[:, ccw]
    return c, p


def _grid_vertices(n, amp=0.04):
    """(n+1)^2 vertices of the unit square, interior ones moved by a smooth
    perturbation (straight-sided, untangled quads)."""
    g = np.linspace(0.0, 1.0, n + 1)
    X, Y = np.meshgrid(g, g, indexing="ij")
    X = X + amp * np.sin(np.pi * X) * np.sin(2 * np.pi * Y)
    Y = Y + amp * np.sin(2 * np.pi * X) * np.sin(np.pi * Y)
    return np.stack([X.ravel(order="F"), Y.ravel(order="F")], 1)


def write_h1_mesh(path, order, n=3, seed=0):
    """An n x n quad mesh of the unit square with perturbed straight sides,
    its elements' vertex cycles started at random vertices, and an H1
    nodes grid function of `order` 2 ("Quadratic") or 3 ("Cubic") at the
    Gauss-Lobatto points of each bilinear element: MFEM's layout, vertices,
    then each edge's order-1 dofs (first-seen, along min -> max vertex id),
    then each element's interior dofs (lex in its own frame)."""
    rng = np.random.default_rng(seed)
    V = _grid_vertices(n)
    elems = []
    for j in range(n):
        for i in range(n):
            v = [i + (n + 1) * j, i + 1 + (n + 1) * j,
                 i + 1 + (n + 1) * (j + 1), i + (n + 1) * (j + 1)]
            k = int(rng.integers(4))
            elems.append(v[k:] + v[:k])
    gll = gauss_lobatto(order + 1)[1:-1]
    edges = {}
    for ev in elems:
        for a, b in zip(ev, ev[1:] + ev[:1]):
            edges.setdefault((min(a, b), max(a, b)), len(edges))
    nodes = [V[v] for v in range(len(V))]
    for (a, b), _ in sorted(edges.items(), key=lambda kv: kv[1]):
        nodes += [V[a] + t * (V[b] - V[a]) for t in gll]
    for ev in elems:
        p0, p1, p2, p3 = (V[v] for v in ev)
        for ty in gll:
            for tx in gll:
                nodes.append((1 - tx) * (1 - ty) * p0 + tx * (1 - ty) * p1
                             + tx * ty * p2 + (1 - tx) * ty * p3)
    fec = {2: "Quadratic", 3: "Cubic"}[order]
    lines = ["MFEM mesh v1.0", "", "dimension", "2", "", "elements",
             str(len(elems))]
    lines += ["1 3 " + " ".join(map(str, ev)) for ev in elems]
    lines += ["", "boundary", "0", "", "vertices", str(len(V)), "",
              "nodes", "FiniteElementSpace",
              f"FiniteElementCollection: {fec}", "VDim: 2", "Ordering: 1",
              ""]
    lines += ["%.17g %.17g" % tuple(x) for x in nodes]
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")


def write_nurbs_2d(path):
    """A quarter annulus (radii 1 and 2) as one degree-2 NURBS patch; the
    arcs' middle control points have weight 1/sqrt(2)."""
    s = np.sqrt(0.5)
    # vertices v0 (1,0), v1 (2,0), v2 (0,2), v3 (0,1); xi radial, eta
    # angular. Edges (knot vector, v0, v1) and their middle points
    edges = [(0, 0, 1), (0, 3, 2), (1, 0, 3), (1, 1, 2)]
    cps = [(1, 0, 1), (2, 0, 1), (0, 2, 1), (0, 1, 1),
           (1.5, 0, 1), (0, 1.5, 1), (1, 1, s), (2, 2, s),
           (1.5, 1.5, s)]
    lines = ["MFEM NURBS mesh v1.0", "", "dimension", "2", "", "elements",
             "1", "1 3 0 1 2 3", "", "boundary", "4", "1 1 0 1", "2 1 1 2",
             "3 1 2 3", "4 1 3 0", "", "edges", "4"]
    lines += ["%d %d %d" % e for e in edges]
    lines += ["", "vertices", "4", "", "knotvectors", "2",
              "2 3 0 0 0 1 1 1", "2 3 0 0 0 1 1 1", "", "weights"]
    lines += ["%.17g" % c[2] for c in cps]
    lines += ["", "FiniteElementSpace", "FiniteElementCollection: NURBS2",
              "VDim: 2", "Ordering: 1", ""]
    lines += ["%.17g %.17g" % c[:2] for c in cps]
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")


_HEX_EDGES = [(0, 1), (1, 2), (3, 2), (0, 3), (4, 5), (5, 6), (7, 6),
              (4, 7), (0, 4), (1, 5), (2, 6), (3, 7)]
_HEX_FACES = [(3, 2, 1, 0), (0, 1, 5, 4), (1, 2, 6, 5), (2, 3, 7, 6),
              (3, 0, 4, 7), (4, 5, 6, 7)]


def write_nurbs_3d(path):
    """The unit cube as one degree-2 NURBS patch with a bulged top face
    (its middle control point raised to z = 1.25) and weights 0.8 on the
    edges, 0.9 on the faces and 0.7 inside. At degree 2 each edge, face and
    the interior hold one control point, their middle, so no orientation
    enters the positions."""
    V = np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0],
                  [0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1]], float)
    cps = [(*v, 1.0) for v in V]
    cps += [(*(0.5 * (V[a] + V[b])), 0.8) for a, b in _HEX_EDGES]
    for f in _HEX_FACES:
        c = V[list(f)].mean(axis=0)
        if f == (4, 5, 6, 7):
            c = c + [0, 0, 0.25]
        cps.append((*c, 0.9))
    cps.append((0.5, 0.5, 0.5, 0.7))
    lines = ["MFEM NURBS mesh v1.0", "", "dimension", "3", "", "elements",
             "1", "1 5 0 1 2 3 4 5 6 7", "", "boundary", "6"]
    lines += ["%d 3 %d %d %d %d" % (k + 1, *f) for k, f in
              enumerate(_HEX_FACES)]
    kv = [0, 1, 0, 0, 1, 1, 0, 0, 2, 2, 2, 2]
    lines += ["", "edges", "12"]
    lines += ["%d %d %d" % (k, a, b) for k, (a, b) in zip(kv, _HEX_EDGES)]
    lines += ["", "vertices", "8", "", "knotvectors", "3"]
    lines += ["2 3 0 0 0 1 1 1"] * 3
    lines += ["", "weights"]
    lines += ["%.17g" % c[3] for c in cps]
    lines += ["", "FiniteElementSpace", "FiniteElementCollection: NURBS2",
              "VDim: 3", "Ordering: 1", ""]
    lines += ["%.17g %.17g %.17g" % c[:3] for c in cps]
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")


def write_general_meshes(d):
    """{"2d", "3d", "cubic": path} in directory d: inline-quad's 8x8 grid
    with mixed start vertices, cube01_hex's 4^3 grid with rotated frames
    (both by the port's writer) and a 6x6 H1 cubic nodes mesh."""
    m2 = umesh.from_arrays(*mixed_start_2d(*structured_corners(
        load_mesh("inline-quad", 1)), 3), 2)
    m3 = umesh3d.from_arrays_3d(*scramble_3d(*structured_corners(
        load_mesh("cube01_hex", 1)), 42), 2)
    out = {}
    for key, m in (("2d", m2), ("3d", m3)):
        out[key] = str(d / f"{key}.mesh")
        with open(out[key], "w") as fh:
            fh.write(vis.mfem_mesh_text(m, m.x))
    out["cubic"] = str(d / "cubic.mesh")
    write_h1_mesh(out["cubic"], 3, n=6, seed=1)
    return out


def rel(a, b):
    return abs(a - b) / max(abs(b), 1e-300)


def run_both(path, **kw):
    """Both drivers on the mesh file `path` (f64, the port on the CPU):
    the same steps, final mass (and us) and max u to 1e-12 relative."""
    cfg = dict(mesh=path, rs_levels=0, verbose=False, **kw)
    rj = jdriver.run(JConfig(**cfg))
    rt = driver.run(RunConfig(device="cpu", **cfg))
    assert (rt.steps, rt.steps_total) == (rj.steps, rj.steps_total)
    assert rel(rt.final_mass_u, rj.final_mass_u) <= 1e-12
    assert rel(rt.max_u, rj.max_u) <= 1e-12
    if rj.final_mass_us:
        assert rel(rt.final_mass_us, rj.final_mass_us) <= 1e-12
    return rj, rt
