"""Sharded runs of the port (gloo ranks on the CPU) against the JAX
package's sharded runs of the same configurations (the conftest gives JAX 8
virtual devices), to 1e-13 in final mass and max u (f64): 8 ranks on a
periodic transport run, -bt 1 (sparsity bounds), -lo 1 (discrete upwind
with -fct 4), -lo 3 on a (2, 2) grid and -lo 4 (subcell residual
distribution). tests/test_torch_sharded.py holds these configurations
against the port's unsharded runs, and four others against the JAX
package's; the JAX runs are split over the two files to keep each short.

The port's runs go through ONE spawn of 8 ranks, each configuration on the
first prod(shard_grid) ranks.
"""

import pytest

from remhos_tpu.config import RunConfig as JConfig
from remhos_tpu.driver import run as jrun

from remhos_torch.parallel import launch
from test_torch_sharded import CASES, _cfg, _close
from torch_threads import one_torch_thread  # noqa: F401

JAX_CASES = ("transport_periodic_8", "sparsity_bounds_8",
             "discrete_upwind_8", "grid_2x2_remap_lo3", "subcell_rd_2")


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    """{name: rank 0's RunResult} of the JAX_CASES, from one spawn."""
    res = launch.spawn_run([_cfg(n) for n in JAX_CASES], 8, "cpu",
                           timeout_s=300.0,
                           init_dir=str(tmp_path_factory.mktemp("pg")))
    return dict(zip(JAX_CASES, res))


@pytest.mark.parametrize("name", JAX_CASES)
def test_sharded_equals_jax_sharded(name, sharded):
    shard, kw = CASES[name]
    rj = jrun(JConfig(verbose=False, use_pallas=kw.get("pa", False),
                      **shard, **kw))
    assert sharded[name].shards == launch.shard_count(_cfg(name)) > 1
    _close(sharded[name], rj)
