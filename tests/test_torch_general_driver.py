"""remhos_torch.driver.run against remhos_tpu.driver.run on general meshes,
on the CPU: both drivers read the same file by path (the JAX package's
general loader and the port's), f64, few steps; final mass and max u to
1e-12 relative, the steps equal.

The meshes: inline-quad's 8x8 grid with each quad's corner cycle started
at a random vertex (2D), and cube01_hex's 4^3 grid with each hex's frame
turned by a random cube rotation (3D), both written by the port's writer,
and the 6x6 grid with an H1 cubic nodes grid function (curved, mesh order
3). The configurations: `-ho 3 -lo 5 -fct 2 -pa` (on the port: kernel 1's
per-dof variant over the CG-node overlap bounds), `-ho 2 -lo 4 -pa`
(kernels 3 and 4, the general subcell boundary mask), the assembled
`-ho 3 -lo 1 -fct 1`, `-bt 1`, and a product remap with IDP-RK
(transport: tests/test_torch_general_transport.py). Also: a checkpoint on
a general mesh resumes to the uninterrupted run; a CFL dt (-dt -1) on a
general mesh is the JAX one.
"""

import pytest

from remhos_torch import driver
from remhos_torch.config import RunConfig
from torch_meshes import rel, run_both, write_general_meshes
from torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def meshes(tmp_path_factory):
    return write_general_meshes(tmp_path_factory.mktemp("general"))


REMAP = dict(problem=10, order=2, dt=0.02, t_final=0.7, max_tsteps=5)
CONFIGS = {
    "ho3-lo5-fct2-pa": dict(ho=3, lo=5, fct=2, pa=True),
    "ho2-lo4-pa": dict(ho=2, lo=4, fct=2, pa=True),
    "ho3-lo1-fct1": dict(ho=3, lo=1, fct=1),
    "bt1-pa": dict(ho=3, lo=5, fct=2, pa=True, bounds_type=1),
}


@pytest.mark.parametrize("mesh", ["2d", "3d"])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_remap_equals_jax(meshes, mesh, name):
    run_both(meshes[mesh], **REMAP, **CONFIGS[name])


@pytest.mark.parametrize("name", ["ho3-lo5-fct2-pa", "ho2-lo4-pa"])
def test_cubic_mesh_equals_jax(meshes, name):
    """Mesh order 3: the kernels' runtime sizes (plain versions here)."""
    run_both(meshes["cubic"], **dict(REMAP, problem=14, order=3),
          **CONFIGS[name])


def test_product_remap_idp_equals_jax(meshes):
    run_both(meshes["2d"], problem=14, order=2, dt=0.005, t_final=0.75,
          max_tsteps=3, ho=3, lo=5, fct=2, pa=True, product_sync=True,
          ode_solver=12)


def test_cfl_dt_equals_jax(meshes):
    rj, rt = run_both(meshes["3d"], problem=10, order=2, dt=-1.0,
                   t_final=0.7, max_tsteps=2, ho=3, lo=5, fct=2, pa=True)
    assert rel(rt.dt, rj.dt) <= 1e-14


def test_checkpoint_resume_general(meshes, tmp_path):
    ck = str(tmp_path / "ck.npz")
    base = dict(mesh=meshes["3d"], rs_levels=0, device="cpu", verbose=False,
                **dict(REMAP, max_tsteps=-1), **CONFIGS["ho3-lo5-fct2-pa"])
    full = driver.run(RunConfig(**dict(base, max_tsteps=6)))
    driver.run(RunConfig(checkpoint_path=ck, checkpoint_steps=3,
                         **dict(base, max_tsteps=3)))
    res = driver.run(RunConfig(checkpoint_path=ck, resume=True,
                               **dict(base, max_tsteps=6)))
    assert res.steps == 6
    assert rel(res.final_mass_u, full.final_mass_u) <= 1e-14
    assert rel(res.max_u, full.max_u) <= 1e-14
