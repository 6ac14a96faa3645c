"""remhos_torch.umesh3d (general hex meshes) against remhos_tpu.umesh3d on
the CPU, and the port's orientation invariance.

- `from_arrays_3d` (neighbours, faces, the affine face maps, nodes, box)
  and `_refine_hex` on cube01_hex's grid whose elements' corner frames are
  turned by random cube rotations (tests/test_umesh3d.py's `_scramble`);
- `build_general_dofmaps_3d` at p = 0..3: `nbr_dof_local[E, 6, fd]`,
  `cg_idx`, `n_cg` and the rest, array for array;
- `load_general_mesh` of a written rotated mesh (3D L2 nodes, and vertex
  files) equals the JAX loader's;
- orientation invariance through the port's driver: the rotated mesh runs
  to the unrotated general mesh's final mass (1e-13) and max u (1e-12),
  tests/test_umesh3d.py:91-92's limits, on the -pa mega stage (kernel 1's
  per-dof variant), the non-fused -ho 2 -lo 4 stage (kernels 3 and 4),
  the assembled -ho 3 -lo 3 -fct 2 of the JAX test, and -bt 1; and on the
  structured grid itself.
"""

import numpy as np
import pytest

from remhos_tpu import umesh as jumesh
from remhos_tpu import umesh3d as jumesh3d

from remhos_torch import driver, umesh, umesh3d, vis
from remhos_torch.config import RunConfig
from remhos_torch.mesh import load_mesh
from torch_meshes import scramble_3d, structured_corners
from torch_threads import one_torch_thread  # noqa: F401

MESH_FIELDS = ("x", "corners", "corner_pos", "nbr_elem", "nbr_face",
               "nbr_map", "lo", "hi", "mesh_order")
DOF_FIELDS = ("nbr_dof_local", "cg_idx", "n_cg", "nbr_elem", "bdr_dofs",
              "sub2ind", "nd", "fd", "nfaces")


def _eq(a, b, fields):
    for f in fields:
        assert np.array_equal(np.asarray(getattr(a, f)),
                              np.asarray(getattr(b, f))), f


def _arrays(rs=1, seed=42, name="cube01_hex"):
    return scramble_3d(*structured_corners(load_mesh(name, rs)), seed)


@pytest.mark.parametrize("rs,seed", [(0, 1), (1, 42), (1, 7), (2, 3)])
def test_from_arrays_3d_equals_jax(rs, seed):
    c, p = _arrays(rs, seed)
    jm, tm = jumesh3d.from_arrays_3d(c, p, 2), umesh3d.from_arrays_3d(c, p, 2)
    _eq(jm, tm, MESH_FIELDS)
    assert not tm.structured and tm.num_elements == 8 ** (rs + 1)
    assert np.array_equal(jm.element_sizes(), tm.element_sizes())
    assert np.array_equal(jm.element_centers(), tm.element_centers())


@pytest.mark.parametrize("seed", [0, 5])
def test_refine_hex_equals_jax(seed):
    c, p = _arrays(0, seed)
    jm = jumesh3d.from_arrays_3d(c, p, 2).refine(2)
    tm = umesh3d.from_arrays_3d(c, p, 2).refine(2)
    _eq(jm, tm, MESH_FIELDS)


@pytest.mark.parametrize("p", [0, 1, 2, 3])
def test_general_dofmaps_3d_equal_jax(p):
    c, pos = _arrays(1, 11)
    jd = jumesh3d.build_general_dofmaps_3d(
        jumesh3d.from_arrays_3d(c, pos, 2), p)
    td = umesh3d.build_general_dofmaps_3d(umesh3d.from_arrays_3d(c, pos, 2),
                                          p)
    _eq(jd, td, DOF_FIELDS)
    assert td.nbr_dof_local.shape == (64, 6, (p + 1) ** 2)


def test_general_dofmaps_3d_periodic_wrap():
    """periodic-cube's corners wrap: a face can be shared across the wrap,
    and its elements meet with rotated frames."""
    c, pos = _arrays(0, 2, "periodic-cube")
    jm = jumesh3d.from_arrays_3d(c, pos, 2)
    tm = umesh3d.from_arrays_3d(c, pos, 2)
    _eq(jm, tm, MESH_FIELDS)
    assert (tm.nbr_elem >= 0).all()
    for p in (2, 3):
        _eq(jumesh3d.build_general_dofmaps_3d(jm, p),
            umesh3d.build_general_dofmaps_3d(tm, p), DOF_FIELDS)


@pytest.mark.parametrize("mo,rs", [(2, 0), (2, 1), (1, 0)])
def test_load_written_equals_jax(mo, rs, tmp_path):
    c, p = _arrays(1, 4)
    tm0 = umesh3d.from_arrays_3d(c, p, mo)
    path = tmp_path / "g.mesh"
    path.write_text(vis.mfem_mesh_text(tm0, tm0.x))
    jm = jumesh.load_general_mesh(str(path), rs)
    tm = umesh.load_general_mesh(str(path), rs)
    _eq(jm, tm, MESH_FIELDS)
    assert tm.num_elements == 64 * 8 ** rs


def test_load_vertex_file_equals_jax(tmp_path):
    c, p = _arrays(1, 8)
    nv = int(c.max()) + 1
    verts = np.zeros((nv, 3))
    verts[c.reshape(-1)] = p.reshape(-1, 3)
    lines = ["MFEM mesh v1.0", "", "dimension", "3", "", "elements",
             str(len(c))]
    lines += ["1 5 " + " ".join(str(v) for v in ev[[0, 1, 3, 2, 4, 5, 7, 6]])
              for ev in c]
    lines += ["", "boundary", "0", "", "vertices", str(nv), "3"]
    lines += ["%.17g %.17g %.17g" % tuple(v) for v in verts]
    path = tmp_path / "v.mesh"
    path.write_text("\n".join(lines) + "\n")
    jm = jumesh.load_general_mesh(str(path), 0)
    tm = umesh.load_general_mesh(str(path), 0)
    _eq(jm, tm, MESH_FIELDS)
    _eq(tm, umesh3d.from_arrays_3d(c, p, 2), ("x", "nbr_map"))


def _run_on(mesh, monkeypatch, **kw):
    monkeypatch.setattr(driver, "load_mesh", lambda *a, **k: mesh)
    return driver.run(RunConfig(mesh="injected", problem=10, rs_levels=0,
                                order=2, dt=0.02, t_final=0.7, max_tsteps=8,
                                device="cpu", verbose=False, **kw))


@pytest.mark.parametrize("kw", [
    dict(ho=3, lo=5, fct=2, pa=True),
    dict(ho=2, lo=4, fct=2, pa=True),
    dict(ho=3, lo=3, fct=2),
    dict(ho=3, lo=5, fct=2, pa=True, bounds_type=1),
    dict(ho=3, lo=5, fct=2, pa=True, dtype="float32")])
def test_orientation_invariance(kw, monkeypatch):
    c, p = structured_corners(load_mesh("cube01_hex", 1))
    base = umesh3d.from_arrays_3d(c, p, 2)
    rot = umesh3d.from_arrays_3d(*scramble_3d(c, p, 42), 2)
    r0 = _run_on(base, monkeypatch, **kw)
    r1 = _run_on(rot, monkeypatch, **kw)
    rs = driver.run(RunConfig(mesh="cube01_hex", problem=10, rs_levels=1,
                              order=2, dt=0.02, t_final=0.7, max_tsteps=8,
                              device="cpu", verbose=False, **kw))
    f32 = kw.get("dtype") == "float32"
    for r in (r1, rs):
        assert r.steps == r0.steps == 8
        assert abs(r0.final_mass_u - r.final_mass_u) < (1e-6 if f32
                                                         else 1e-13)
        assert abs(r0.max_u - r.max_u) < (1e-5 if f32 else 1e-12)
    if f32:
        # remap RK3: the f32 closure runs on general meshes too
        assert 0 < r1.mass_closure_injected_rel < 1e-4
