"""`-mono 1|2` through remhos_torch.driver.run, against
remhos_tpu.driver.run on the CPU; and `mono_rd_solution` on a smooth p=1
field whose inner loop converges in every element before its cap (48
iterations), against the JAX package's (1e-12 of max|du|).

tests/test_driver.py::test_mono_transport and test_mono_subcell, cut to 3
of their 6 steps, through both drivers (final mass and max u to 1e-12),
with that test's gates on the port; and an f32 `-mono 2 -si 2` run that
tracks the f64 one by tests/test_f32_goldens.py's rule.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from remhos_tpu import driver as jdriver
from remhos_tpu import mono as jmono
from remhos_tpu.config import RunConfig as JConfig
from remhos_tpu.discretization import build_discretization as jbuild
from remhos_tpu.mesh import load_mesh as jload
from remhos_tpu.operator import Advection as JAdvection
from remhos_tpu.operator import SolverConfig as JSolverConfig

from remhos_torch import driver, mono
from remhos_torch.config import RunConfig
from remhos_torch.discretization import build_discretization
from remhos_torch.mesh import load_mesh
from remhos_torch.operator import Advection, SolverConfig
from torch_threads import one_torch_thread  # noqa: F401


def test_converging_inner_loop_matches_jax():
    jd = jbuild(jload("inline-quad", 1), 1)
    td = build_discretization(load_mesh("inline-quad", 1), 1)
    kw = dict(problem=4, ho=0, lo=0, fct=0, mono=2, pa=False)
    jadv = JAdvection(jd, JSolverConfig(**kw), jnp.asarray(jd.mesh.x))
    tadv = Advection(td, SolverConfig(**kw), td.mesh.x,
                     dtype=torch.float64, device="cpu")
    x = np.einsum("end,mn->emd", jd.mesh.x, jd.Bm_at_unodes)
    u = np.exp(-3.0 * ((x - 0.2) ** 2).sum(-1))
    got = mono.mono_rd_solution(tadv, tadv.geometry(0.0), torch.as_tensor(u),
                                0.005)
    want = np.asarray(jmono.mono_rd_solution(
        jadv, jadv.geometry(0.0), jnp.asarray(u), 0.005))
    assert np.abs(got.numpy() - want).max() <= 1e-12 * np.abs(want).max()
    assert tadv.mono_stats["iterations"] < mono.MAX_ITER

MONO = dict(mesh="periodic-square", problem=4, rs_levels=2, order=2,
            dt=0.005, t_final=0.03, ho=0, lo=0, fct=0, max_tsteps=3,
            verbose=False)


@pytest.mark.parametrize("mono_type", [1, 2])
def test_mono_driver_matches_jax(mono_type):
    kw = dict(MONO, mono=mono_type)
    rj = jdriver.run(JConfig(**kw))
    rt = driver.run(RunConfig(device="cpu", **kw))
    assert rt.steps == rj.steps == 3
    for a, b in ((rt.final_mass_u, rj.final_mass_u), (rt.max_u, rj.max_u)):
        assert abs(a - b) <= 1e-12 * abs(b)
    assert rt.mass_loss_u < 1e-11 and rt.max_u <= 1.0 + 1e-9


def test_mono_f32_tracks_f64():
    kw = dict(MONO, mono=2, smth_ind=2, device="cpu")
    r64 = driver.run(RunConfig(**kw))
    r32 = driver.run(RunConfig(dtype="float32", **kw))
    assert r32.mass_loss_u < max(1e-5, 50 * r64.mass_loss_u)
    assert abs(r32.final_mass_u - r64.final_mass_u) < \
        1e-5 * r64.final_mass_u
    assert abs(r32.max_u - r64.max_u) < 1e-3
