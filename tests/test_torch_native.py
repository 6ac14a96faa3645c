"""remhos_torch.native (the port's own copy of the C++ setup tables and MFEM
parser, built with g++ into remhos_torch/_build/) against numpy and the JAX
package's binding on the CPU.

- the structured neighbour and CG-node tables equal the port's numpy
  versions (`dofmaps.neighbour_elements`, `dofmaps.cg_node_ids`) and the
  JAX package's native ones (tests/test_native.py:20-36);
- both parsers read the same files into equal arrays: files the port's
  writer makes (L2 nodes of order 1-3, 1D, 2D, 3D, general meshes), a
  vertex-based file and an inline file;
- the library is the port's build, in its build directory, and a source
  that does not compile raises with g++'s message.
"""

import numpy as np
import pytest

from remhos_tpu import native as jnative

from remhos_torch import dofmaps, umesh3d, vis
from remhos_torch.mesh import load_mesh, make_cartesian_mesh
from remhos_torch.native import tables
from torch_meshes import scramble_3d, structured_corners
from torch_threads import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("dim,shape,per", [
    (2, (5, 3), (True, False)), (3, (4, 3, 2), (False, True, True)),
    (1, (7,), (True,)), (3, (2, 2, 2), (False, False, False))])
def test_neighbor_table_matches_numpy(dim, shape, per):
    nat = tables.build_neighbor_table(shape, per)
    assert np.array_equal(nat, dofmaps.neighbour_elements(shape, per))
    assert np.array_equal(nat, jnative.build_neighbor_table(shape, per))


@pytest.mark.parametrize("shape,per,q", [
    ((4, 4), (True, True), 3), ((3, 2, 2), (False, False, True), 2),
    ((5,), (False,), 4), ((2, 3), (False, True), 1)])
def test_cg_index_matches_numpy(shape, per, q):
    nat = tables.build_cg_index(shape, per, q)
    cg, n_cg = dofmaps.cg_node_ids(shape, per, q)
    assert np.array_equal(nat, cg) and nat.max() < n_cg
    assert np.array_equal(nat, jnative.build_cg_index(shape, per, q))


def _same_parse(path):
    t, j = tables.load_mfem_mesh(str(path)), jnative.load_mfem_mesh(str(path))
    assert t.keys() == j.keys()
    for k in t:
        if isinstance(t[k], np.ndarray):
            assert t[k].dtype == j[k].dtype and np.array_equal(t[k], j[k]), k
        else:
            assert t[k] == j[k], k
    return t


@pytest.mark.parametrize("name,rs,mo", [
    ("inline-quad", 1, 2), ("periodic-square", 0, 3), ("cube01_hex", 1, 2),
    ("periodic-cube", 0, 1), ("periodic-segment", 1, 2)])
def test_parse_written_structured(name, rs, mo, tmp_path):
    m = load_mesh(name, rs, mo)
    path = tmp_path / "m.mesh"
    path.write_text(vis.mfem_mesh_text(m, m.x))
    t = _same_parse(path)
    assert t["kind"] == "v10" and t["dim"] == m.dim
    assert t["l2_order"] == mo
    # %.16g text: the nodes to a unit or two of the last place
    assert np.abs(t["l2_nodes"] - m.x).max() < 4e-16 * np.abs(m.x).max()


def test_parse_written_general_3d(tmp_path):
    c, p = scramble_3d(*structured_corners(load_mesh("cube01_hex", 1)), 3)
    m = umesh3d.from_arrays_3d(c, p, 2)
    path = tmp_path / "g.mesh"
    path.write_text(vis.mfem_mesh_text(m, m.x))
    t = _same_parse(path)
    assert np.array_equal(t["elem_verts"][:, [0, 1, 3, 2, 4, 5, 7, 6]], c)
    assert np.abs(t["l2_nodes"] - m.x).max() < 1e-15


def test_parse_vertex_file(tmp_path):
    """A v1.0 file with a vertices section (no nodes)."""
    m = make_cartesian_mesh(2, (3, 2), (0.0, 0.0), (1.5, 1.0),
                            (False, False))
    corners, nv = vis._structured_corner_ids(m)
    verts = np.zeros((nv, 2))
    verts[corners.reshape(-1)] = m.x[:, [0, 2, 6, 8]].reshape(-1, 2)
    lines = ["MFEM mesh v1.0", "", "dimension", "2", "", "elements", "6"]
    lines += ["1 3 " + " ".join(str(v) for v in ev[[0, 1, 3, 2]])
              for ev in corners]
    lines += ["", "boundary", "1", "1 1 0 1", "", "vertices", str(nv), "2"]
    lines += ["%.17g %.17g" % tuple(v) for v in verts]
    path = tmp_path / "v.mesh"
    path.write_text("\n".join(lines) + "\n")
    t = _same_parse(path)
    assert np.array_equal(t["verts"], verts)
    assert t["elem_verts"].shape == (6, 4)


def test_parse_inline(tmp_path):
    path = tmp_path / "inline.mesh"
    path.write_text("MFEM INLINE mesh v1.0\n\ntype = quad\nnx = 4\nny = 3\n"
                    "sx = 1.0\nsy = 0.5\n")
    t = _same_parse(path)
    assert t == {"kind": "inline", "dim": 2, "n": (4, 3), "s": (1.0, 0.5)}


def test_library_is_the_ports_build():
    lib = tables.library_path()
    assert lib.parent.name == "_build" and lib.parent.parent.name == \
        "remhos_torch"
    assert tables.load()._name == str(lib) and lib.exists()


def test_failed_build_raises(tmp_path, monkeypatch):
    bad = tmp_path / "bad.cpp"
    bad.write_text("extern \"C\" int f() { return undefined_name; }\n")
    monkeypatch.setattr(tables, "SRC", bad)
    monkeypatch.setattr(tables, "BUILD_DIR", tmp_path / "_build")
    with pytest.raises(RuntimeError, match="undefined_name"):
        tables.build()
    assert not list((tmp_path / "_build").glob("*.so"))
