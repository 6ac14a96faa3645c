"""remhos_torch.umesh (general 2D quad meshes) against remhos_tpu.umesh on
the CPU: the same corner arrays and files give equal arrays, and the dof
maps are equal array for array.

- `from_arrays` (neighbours, faces, tangential flips, nodes, bounding box)
  and `_refine_quad` on quads whose corner cycles start at mixed vertices;
- `build_general_dofmaps` at p = 0..4: `nbr_dof_local[E, 4, fd]`, `cg_idx`,
  `n_cg`, `nbr_elem`, `bdr_dofs`, `sub2ind`;
- `load_general_mesh` on files: the port's writer (L2 nodes, mesh orders 1-3,
  mixed starts), the JAX writer, H1 "Quadratic" and "Cubic" node files
  (whose neighbouring elements must place the same points on each shared
  edge, tests/test_curved_meshes.py's continuity check), at rs 0 and 1;
- element sizes and centres; the subcell boundary mask of a general mesh.
"""

import numpy as np
import pytest

from remhos_tpu import subcell as jsubcell
from remhos_tpu import umesh as jumesh
from remhos_tpu import vis as jvis

from remhos_torch import subcell, umesh, vis
from remhos_torch.discretization import build_discretization
from remhos_torch.mesh import load_mesh
from torch_meshes import mixed_start_2d, structured_corners, write_h1_mesh
from torch_threads import one_torch_thread  # noqa: F401

MESH_FIELDS = ("x", "corners", "corner_pos", "nbr_elem", "nbr_face",
               "nbr_flip", "lo", "hi", "mesh_order")
DOF_FIELDS = ("nbr_dof_local", "cg_idx", "n_cg", "nbr_elem", "bdr_dofs",
              "sub2ind", "nd", "fd", "nfaces")


def _eq(a, b, fields):
    for f in fields:
        va, vb = getattr(a, f), getattr(b, f)
        assert np.array_equal(np.asarray(va), np.asarray(vb)), f


def _arrays(name="inline-quad", rs=1, seed=0, mo=2):
    return mixed_start_2d(*structured_corners(load_mesh(name, rs, mo)), seed)


@pytest.mark.parametrize("name,rs,seed", [
    ("inline-quad", 0, 0), ("inline-quad", 1, 1), ("periodic-square", 1, 2),
    ("inline-quad", 2, 3)])
def test_from_arrays_equals_jax(name, rs, seed):
    c, p = _arrays(name, rs, seed)
    jm, tm = jumesh.from_arrays(c, p, 2), umesh.from_arrays(c, p, 2)
    _eq(jm, tm, MESH_FIELDS)
    assert tm.nbr_flip.any() and not tm.structured
    _eq(jm.refine(2), tm.refine(2), MESH_FIELDS)
    assert np.array_equal(jm.element_sizes(), tm.element_sizes())
    assert np.array_equal(jm.element_centers(), tm.element_centers())


@pytest.mark.parametrize("p", [0, 1, 2, 3, 4])
def test_general_dofmaps_equal_jax(p):
    c, pos = _arrays("inline-quad", 1, 5)
    jm, tm = jumesh.from_arrays(c, pos, 2), umesh.from_arrays(c, pos, 2)
    jd = jumesh.build_general_dofmaps(jm, p)
    td = umesh.build_general_dofmaps(tm, p)
    _eq(jd, td, DOF_FIELDS[:-3] if p == 0 else DOF_FIELDS)
    assert td.nbr_dof_local.shape == (64, 4, p + 1)


def test_general_dofmaps_equal_jax_refined_periodic():
    """A mixed-start periodic grid refined twice: repeated vertex ids
    across the wrap, and the refined vertices' first-seen numbering."""
    c, pos = _arrays("periodic-square", 0, 9)
    jm = jumesh.from_arrays(c, pos, 2).refine(2)
    tm = umesh.from_arrays(c, pos, 2).refine(2)
    for p in (2, 3):
        _eq(jumesh.build_general_dofmaps(jm, p),
            umesh.build_general_dofmaps(tm, p), DOF_FIELDS)


@pytest.mark.parametrize("mo,rs,seed", [(1, 0, 0), (2, 0, 1), (2, 1, 2),
                                        (3, 1, 3)])
def test_load_port_written_equals_jax(mo, rs, seed, tmp_path):
    c, p = _arrays("inline-quad", 1, seed, mo)
    x = load_mesh("inline-quad", 1, mo).x
    tm0 = umesh.from_arrays(c, p, mo)
    path = tmp_path / "w.mesh"
    path.write_text(vis.mfem_mesh_text(tm0, tm0.x))
    jm = jumesh.load_general_mesh(str(path), rs)
    tm = umesh.load_general_mesh(str(path), rs)
    _eq(jm, tm, MESH_FIELDS)
    assert tm.num_elements == 64 * 4 ** rs
    if rs == 0 and mo > 1:
        # the nodes of each element are the grid's, in its rotated frame
        assert np.abs(np.sort(tm.x.reshape(-1, 2), 0)
                      - np.sort(x.reshape(-1, 2), 0)).max() < 1e-15


def test_load_jax_written_equals_jax(tmp_path):
    c, p = _arrays("inline-quad", 1, 4)
    jm0 = jumesh.from_arrays(c, p, 2)
    path = tmp_path / "j.mesh"
    path.write_text(jvis.mfem_mesh_text(jm0, jm0.x))
    _eq(jumesh.load_general_mesh(str(path), 1),
        umesh.load_general_mesh(str(path), 1), MESH_FIELDS)


def _face_ids(n1):
    ix = np.arange(n1)
    return [ix, n1 - 1 + n1 * ix, n1 * (n1 - 1) + ix, n1 * ix]


@pytest.mark.parametrize("order,rs", [(2, 0), (2, 1), (3, 0), (3, 1)])
def test_h1_nodes_mesh_equals_jax(order, rs, tmp_path):
    path = tmp_path / f"h{order}.mesh"
    write_h1_mesh(str(path), order, seed=order)
    jm = jumesh.load_general_mesh(str(path), rs)
    tm = umesh.load_general_mesh(str(path), rs)
    _eq(jm, tm, MESH_FIELDS)
    assert tm.mesh_order == order
    fid = _face_ids(order + 1)
    checked = 0
    for e in range(tm.num_elements):
        for f in range(4):
            e2 = tm.nbr_elem[e, f]
            if e2 < 0:
                continue
            nbr = tm.x[e2, fid[tm.nbr_face[e, f]]]
            if tm.nbr_flip[e, f]:
                nbr = nbr[::-1]
            assert np.abs(tm.x[e, fid[f]] - nbr).max() < 1e-13
            checked += 1
    assert checked == 2 * (12 if rs == 0 else 60)


@pytest.mark.parametrize("p", [1, 2, 3])
def test_boundary_node_mask_equals_jax(p):
    c, pos = _arrays("inline-quad", 1, 6)
    tm = umesh.from_arrays(c, pos, 2)
    disc = build_discretization(tm, p)
    got = subcell.boundary_node_mask(tm, disc.ref_nodes_u)
    ref = jsubcell.boundary_node_mask(jumesh.from_arrays(c, pos, 2),
                                      disc.ref_nodes_u)
    assert np.array_equal(got, ref)
    # 32 boundary faces of p+1 nodes, the 4 corner elements share one
    assert got.sum() == 32 * (p + 1) - 4
