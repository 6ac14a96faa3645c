"""remhos_torch.nurbs against remhos_tpu.nurbs on the CPU, on one-patch
degree-2 NURBS files with weights that are not 1 (written by the test: the
reference's disc-nurbs and ball-nurbs files are not in the repository).

- the parsers, the homogeneous control nets and the de Casteljau split give
  equal arrays (2D and 3D, with both 3D face layouts);
- `load_nurbs_mesh*` (through `umesh.load_general_mesh`) give equal meshes
  at rs 0-2 and mesh orders 2 and 3; the 2D patch is a quarter annulus, so
  every node lies between radii 1 and 2 and the arcs are exact circles;
- a remap on the refined 2D patch runs on both drivers to the same final
  mass and max u (1e-12 relative).
"""

import numpy as np
import pytest

from remhos_tpu import driver as jdriver
from remhos_tpu import nurbs as jnurbs
from remhos_tpu import umesh as jumesh
from remhos_tpu.config import RunConfig as JConfig

from remhos_torch import driver, nurbs, umesh
from remhos_torch.config import RunConfig
from torch_meshes import write_nurbs_2d, write_nurbs_3d
from torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("nurbs")
    write_nurbs_2d(str(d / "annulus.mesh"))
    write_nurbs_3d(str(d / "cube.mesh"))
    return {2: str(d / "annulus.mesh"), 3: str(d / "cube.mesh")}


def _same(a, b):
    if isinstance(a, (tuple, list)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _same(a[k], b[k])
    else:
        assert np.array_equal(np.asarray(a), np.asarray(b))


def test_parse_2d_equals_jax(files):
    t = nurbs.parse_nurbs_mesh(files[2])
    _same(t, jnurbs.parse_nurbs_mesh(files[2]))
    assert t[-1] == 2 and not np.all(t[3] == 1.0)


def test_parse_3d_equals_jax(files):
    t = nurbs.parse_nurbs_mesh_3d(files[3])
    _same(t, jnurbs.parse_nurbs_mesh_3d(files[3]))
    assert len(t[4]) == 6 and t[-1] == 2


def test_control_nets_equal_jax(files):
    _same(nurbs.control_nets(files[2]), jnurbs.control_nets(files[2]))
    for layout in ("s-fast", "t-fast"):
        _same(nurbs.control_nets_3d(files[3], layout),
              jnurbs.control_nets_3d(files[3], layout))


@pytest.mark.parametrize("axis", [0, 1, 2])
def test_decasteljau_split_equals_jax(axis):
    H = np.random.default_rng(axis).random((3, 4, 5, 4))
    _same(nurbs._decasteljau_split(H, axis),
          jnurbs._decasteljau_split(H, axis))


@pytest.mark.parametrize("dim,rs,mo", [(2, 0, 2), (2, 1, 2), (2, 2, 3),
                                       (3, 0, 2), (3, 1, 2), (3, 1, 3)])
def test_load_equals_jax(files, dim, rs, mo):
    jm = jumesh.load_general_mesh(files[dim], rs, mo)
    tm = umesh.load_general_mesh(files[dim], rs, mo)
    fields = ("x", "corners", "corner_pos", "nbr_elem", "nbr_face", "lo",
              "hi") + (("nbr_flip",) if dim == 2 else ("nbr_map",))
    for f in fields:
        assert np.array_equal(np.asarray(getattr(jm, f)),
                              np.asarray(getattr(tm, f))), f
    assert tm.num_elements == 2 ** (dim * rs)
    if dim == 2:
        r = np.linalg.norm(tm.x, axis=-1)
        assert r.min() > 1 - 1e-14 and r.max() < 2 + 1e-14
        # the inner and outer arcs' nodes lie on their circles
        on_arc = np.isclose(r, 1.0, atol=1e-12) | np.isclose(r, 2.0,
                                                             atol=1e-12)
        assert on_arc.sum() == 2 * (2 ** rs) * (mo + 1)
    else:
        assert tm.x[..., 2].max() > 1.0          # the bulged top face


def test_remap_on_nurbs_equals_jax(files):
    cfg = dict(mesh=files[2], problem=10, rs_levels=2, order=2, dt=0.02,
               t_final=0.7, max_tsteps=4, ho=3, lo=5, fct=2, pa=True,
               verbose=False)
    rj = jdriver.run(JConfig(**cfg))
    rt = driver.run(RunConfig(device="cpu", **cfg))
    assert rt.steps == rj.steps == 4
    assert abs(rt.final_mass_u - rj.final_mass_u) <= 1e-12 * abs(
        rj.final_mass_u)
    assert abs(rt.max_u - rj.max_u) <= 1e-12 * abs(rj.max_u)
