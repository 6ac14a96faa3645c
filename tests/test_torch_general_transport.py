"""Transport on a general mesh, remhos_torch.driver.run against
remhos_tpu.driver.run on the CPU (the remap cases are
tests/test_torch_general_driver.py's): the mixed-start 8x8 quad mesh read
by path on both sides, f64, final mass and max u to 1e-12 relative; the
inflow and outflow of a non-periodic general mesh, with the fused-family
-pa stage (transport takes no kernel), residual distribution and the
assembled subcell scheme. A general mesh counts as not periodic in
transport, so an f32 run has no closure, as in the JAX package
(remhos_tpu/driver.py:249).
"""

import pytest

from remhos_torch import driver
from remhos_torch.config import RunConfig
from torch_meshes import run_both, write_general_meshes
from torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def meshes(tmp_path_factory):
    return write_general_meshes(tmp_path_factory.mktemp("general"))


@pytest.mark.parametrize("kw", [
    dict(problem=5, ho=3, lo=5, fct=2, pa=True),
    dict(problem=5, ho=2, lo=3, fct=2, pa=True),
    dict(problem=0, ho=3, lo=4, fct=2)])
def test_transport_equals_jax(meshes, kw):
    run_both(meshes["2d"], order=2, dt=0.005, t_final=0.02, **kw)


def test_transport_f32_no_closure(meshes):
    """On a general mesh transport is not periodic: no f32 closure (the
    JAX driver's `conservative` test, remhos_tpu/driver.py:249)."""
    r = driver.run(RunConfig(mesh=meshes["2d"], rs_levels=0, problem=5,
                             order=2, dt=0.005, t_final=0.02, ho=3, lo=5,
                             fct=2, pa=True, dtype="float32", device="cpu",
                             verbose=False))
    assert r.mass_closure_injected_rel == 0.0 and r.steps == 4


