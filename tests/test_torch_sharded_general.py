"""The general sharded route of the port (`parallel/gsharded.py`): Morton
blocks, ghost padding and the table-driven halos, on the CPU with gloo
ranks, against the port's unsharded runs (1e-13 in final mass and max u,
f64, relative where the mass is O(1)) and the JAX package's tables.

- `morton_permutation`, `build_facedof_table`, `structured_nbr_face` equal
  the JAX package's;
- odd counts on grids (tests/test_sharded_odd.py's cases: 3 and 5 ranks,
  2 and 1 ghost elements, -lo 3|4|5, remap and transport, 2D and 3D);
- general meshes from files written by tests/torch_meshes.py (the
  reference's .mesh files are absent): an 8x8 quad grid with mixed corner
  frames and a rotated 4^3 hex grid, at 3 and 5 ranks, -bt 0|1, -lo 3|4,
  -pa with the mega stage (kernel 1's per-dof variant, its plain version
  here), product remap with IDP-RK;
- the JAX package's general-sharded mega fault (ROADMAP.md, known faults
  of the reference): inline-quad -rs 1 -o 2 -p 14 -ho 3 -lo 5 -fct 2 -pa
  over 3 ranks, where JAX raises a broadcasting ValueError; the port runs
  it through the per-dof variant and matches the unsharded run
  (mass 0.09711408880059925, max u 1.0 in the JAX package's unsharded run);
- -mono with shards raises NotImplementedError, as in the JAX package; -dcn
  leaves the result bit for bit.
"""

import dataclasses

import numpy as np
import pytest

from remhos_tpu.config import RunConfig as JConfig
from remhos_tpu.driver import run as jrun
from remhos_tpu.parallel import gsharded as jgs
from remhos_tpu.mesh import load_mesh as jload

from remhos_torch import driver
from remhos_torch.config import RunConfig
from remhos_torch.discretization import build_discretization
from remhos_torch.mesh import load_mesh
from remhos_torch.parallel import gsharded as gs
from remhos_torch.parallel import launch
from torch_meshes import write_general_meshes
from torch_threads import one_torch_thread  # noqa: F401

IQ = dict(mesh="inline-quad", rs_levels=1, order=2)
CASES = {
    "iq_3_lo5": (3, dict(IQ, problem=4, dt=0.005, t_final=0.02, ho=3, lo=5,
                         fct=2)),
    "iq_5_lo3": (5, dict(IQ, problem=4, dt=0.005, t_final=0.02, ho=3, lo=3,
                         fct=2)),
    "hex_3": (3, dict(mesh="cube01_hex", problem=0, rs_levels=1, order=2,
                      dt=0.01, t_final=0.03, ho=3, lo=5, fct=2)),
    "remap_3": (3, dict(IQ, problem=14, dt=0.01, t_final=1.0, max_tsteps=4,
                        ho=3, lo=5, fct=2)),
    "subcell_3": (3, dict(IQ, problem=14, dt=0.01, t_final=1.0,
                          max_tsteps=4, ho=3, lo=4, fct=2)),
    # the JAX package's fault: 16 elements over 3 ranks, 2 ghosts
    "mega_fault_3": (3, dict(IQ, problem=14, dt=0.005, t_final=0.75,
                             max_tsteps=2, ho=3, lo=5, fct=2, pa=True)),
    "pa_rd_5": (5, dict(IQ, problem=14, dt=0.005, t_final=0.75,
                        max_tsteps=2, ho=3, lo=3, fct=2, pa=True)),
}
# on the general mesh files (key -> the file of write_general_meshes)
FILE_CASES = {
    "quad_3_bt0": ("2d", 3, dict(problem=5, order=2, dt=0.004, t_final=0.02,
                                 ho=3, lo=3, fct=2)),
    "quad_5_bt1": ("2d", 5, dict(problem=5, order=2, dt=0.004, t_final=0.02,
                                 ho=3, lo=5, fct=2, bounds_type=1)),
    "quad_3_subcell": ("2d", 3, dict(problem=14, order=2, dt=0.01,
                                     t_final=1.0, max_tsteps=3, ho=3, lo=4,
                                     fct=2)),
    "quad_3_mega": ("2d", 3, dict(problem=14, order=3, dt=0.005,
                                  t_final=0.75, max_tsteps=3, ho=3, lo=5,
                                  fct=2, pa=True)),
    "hex_5_mega": ("3d", 5, dict(problem=10, order=2, dt=0.02, t_final=0.7,
                                 max_tsteps=3, ho=3, lo=5, fct=2, pa=True)),
    "quad_3_product": ("2d", 3, dict(problem=14, order=2, dt=0.005,
                                     t_final=0.75, max_tsteps=3, ho=3, lo=5,
                                     fct=2, product_sync=True,
                                     ode_solver=12)),
}


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    return write_general_meshes(tmp_path_factory.mktemp("meshes"))


def _cfg(name, files, sharded=True):
    if name in CASES:
        n, kw = CASES[name]
    else:
        key, n, kw = FILE_CASES[name]
        kw = dict(kw, mesh=files[key], rs_levels=0)
    return RunConfig(device="cpu", verbose=False,
                     **(dict(n_shards=n) if sharded else {}), **kw)


@pytest.fixture(scope="module")
def sharded(files, tmp_path_factory):
    """{name: rank 0's RunResult}, every case from one spawn of 5 ranks,
    and the -dcn twin of the fault case."""
    names = list(CASES) + list(FILE_CASES)
    cfgs = [_cfg(n, files) for n in names]
    cfgs.append(dataclasses.replace(_cfg("mega_fault_3", files), dcn=True))
    res = launch.spawn_run(cfgs, 5, "cpu", timeout_s=300.0,
                           init_dir=str(tmp_path_factory.mktemp("pg")))
    out = dict(zip(names, res))
    out["dcn"] = res[-1]
    return out


def _close(a, b):
    assert abs(a.final_mass_u - b.final_mass_u) <= 1e-13 * max(
        1.0, abs(b.final_mass_u))
    assert abs(a.max_u - b.max_u) <= 1e-13


@pytest.mark.parametrize("name", list(CASES) + list(FILE_CASES))
def test_general_route_equals_unsharded(name, sharded, files):
    rs, r1 = sharded[name], driver.run(_cfg(name, files, sharded=False))
    assert rs.steps_total == r1.steps_total
    _close(rs, r1)
    assert abs(rs.mass_loss_u - r1.mass_loss_u) <= 1e-13
    if r1.final_mass_us:
        assert abs(rs.final_mass_us - r1.final_mass_us) <= 1e-13
        assert abs(rs.max_s - r1.max_s) <= 1e-12


def test_reference_fault_config_runs(sharded):
    """The JAX package's unsharded numbers of the fault configuration (its
    sharded run raises), and -dcn bit for bit."""
    r = sharded["mega_fault_3"]
    assert abs(r.final_mass_u - 0.09711408880059925) <= 1e-13
    assert r.max_u == 1.0
    assert (sharded["dcn"].final_mass_u, sharded["dcn"].max_u) == (
        r.final_mass_u, r.max_u)
    with pytest.raises(ValueError, match="broadcast"):
        jrun(JConfig(verbose=False, use_pallas=True, n_shards=3,
                     **CASES["mega_fault_3"][1]))


def test_mono_with_shards_raises():
    with pytest.raises(NotImplementedError, match="single-shard"):
        driver.run(RunConfig(**dict(CASES["iq_3_lo5"][1], mono=1, ho=0,
                                    lo=0, fct=0), n_shards=3, device="cpu",
                             verbose=False))


@pytest.mark.parametrize("name,rs", [("inline-quad", 2), ("cube01_hex", 1)])
def test_tables_equal_jax(name, rs, files):
    mesh, jmesh = load_mesh(name, rs), jload(name, rs)
    c = mesh.element_centers()
    assert np.array_equal(gs.morton_permutation(c),
                          jgs.morton_permutation(jmesh.element_centers()))
    nf = gs.structured_nbr_face(mesh)
    assert np.array_equal(nf, jgs.structured_nbr_face(jmesh))
    dm = build_discretization(mesh, 2).dofmaps
    from remhos_tpu.discretization import build_discretization as jbuild
    jdm = jbuild(jmesh, 2).dofmaps
    assert np.array_equal(gs.build_facedof_table(dm, nf),
                          jgs.build_facedof_table(jdm, nf))
    gm = driver.load_mesh(files["2d"], 0)
    from remhos_tpu.umesh import load_general_mesh as jload_general
    jgm = jload_general(files["2d"], 0)
    assert np.array_equal(gs.morton_permutation(gm.element_centers()),
                          jgs.morton_permutation(jgm.element_centers()))
    gdm = build_discretization(gm, 2).dofmaps
    assert np.array_equal(gs.build_facedof_table(gdm, gm.nbr_face),
                          jgs.build_facedof_table(
                              jbuild(jgm, 2).dofmaps, jgm.nbr_face))
