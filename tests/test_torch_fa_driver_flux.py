"""remhos_torch.driver.run against remhos_tpu.driver.run on the CPU: the
flux-based (`-fct 1`) and nonlinear-penalty (`-fct 3`) cases of
tests/test_driver.py, with the same configurations and lengths, and two
short 3D remap runs of the assembled path (`-ho 1 -lo 2`, `-ho 3 -lo 4`).
Tolerances as tests/test_torch_fa_driver.py: final masses and max u
<= 1e-12 relative in f64, step counts equal."""

import pytest

from remhos_tpu import driver as jdriver
from remhos_tpu.config import RunConfig as JConfig

from remhos_torch import driver
from remhos_torch.config import RunConfig
from torch_threads import one_torch_thread  # noqa: F401

TRANSPORT = dict(mesh="periodic-square", problem=4, verbose=False)
PACMAN = dict(mesh="inline-quad", problem=14, rs_levels=1, order=3,
              t_final=0.75, verbose=False)
CUBE = dict(mesh="cube01_hex", problem=10, rs_levels=0, order=2, dt=0.02,
            t_final=0.7, max_tsteps=4, verbose=False)


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-300)


@pytest.mark.parametrize("name,kw", [
    ("flux_based_fct_transport",
     dict(TRANSPORT, rs_levels=2, order=3, dt=0.005, t_final=0.05, ho=3,
          lo=1, fct=1)),
    ("flux_based_fct_remap",
     dict(PACMAN, dt=0.0015, max_tsteps=10, ho=3, lo=1, fct=1)),
    ("flux_based_product_remap",
     dict(PACMAN, dt=0.005, max_tsteps=10, ho=3, lo=1, fct=1,
          product_sync=True, ode_solver=1)),
    ("nonlinear_penalty",
     dict(TRANSPORT, rs_levels=2, order=3, dt=0.005, t_final=0.05, ho=3,
          lo=3, fct=3)),
    ("remap_3d_du_prec_neumann", dict(CUBE, ho=1, lo=2, fct=2)),
    ("remap_3d_subcell", dict(CUBE, ho=3, lo=4, fct=2))])
def test_fa_matches_jax(name, kw):
    rj = jdriver.run(JConfig(**kw))
    rt = driver.run(RunConfig(device="cpu", **kw))
    assert (rt.steps, rt.steps_total) == (rj.steps, rj.steps_total)
    assert _rel(rt.final_mass_u, rj.final_mass_u) <= 1e-12
    assert _rel(rt.max_u, rj.max_u) <= 1e-12
    if kw.get("product_sync"):
        assert _rel(rt.final_mass_us, rj.final_mass_us) <= 1e-12
        assert _rel(rt.max_s, rj.max_s) <= 1e-10
        assert rt.max_s <= 3.0 + 1e-8
    assert rt.mass_closure_injected_rel == 0.0
