"""remhos_torch.mono (the monolithic RD solvers, `-mono 1|2`, with and
without `-si 1|2`) against remhos_tpu on the CPU.

- `velocity_scale` and `nonlin_flux_lumping` on the same inputs: 1e-13;
- `mono_rd_solution` on the same operator and seeded field, for `-mono
  1|2` and `-si 0|1|2`, on a periodic and a non-periodic mesh (transport
  problem 4, whose mass limiting runs the inner consistent-mass loop): f64,
  1e-12 of max|du|. On these fields some elements never reach the loop's
  tolerance and it stops at its cap, in the JAX package too; on a smooth
  p=1 field every element converges first (48 iterations): that case is
  in tests/test_torch_mono_driver.py (its JAX side compiles for ~10 s);
- the inner loop's exit test every k iterations, on that smooth case: the
  same bits for k = 1, 3, 8 and more than the cap, one read-back per k
  iterations, never more than the JAX package's 101 iterations.

The driver runs are in tests/test_torch_mono_driver.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from remhos_tpu import mono as jmono
from remhos_tpu.discretization import build_discretization as jbuild
from remhos_tpu.mesh import load_mesh as jload
from remhos_tpu.operator import Advection as JAdvection
from remhos_tpu.operator import SolverConfig as JSolverConfig

from remhos_torch import mono, mono_lumping
from remhos_torch.discretization import build_discretization
from remhos_torch.mesh import load_mesh
from remhos_torch.operator import Advection, SolverConfig
from torch_threads import one_torch_thread  # noqa: F401

# (mesh, refinements, order, noise on the field): on the last, smooth case
# every element's inner loop converges before the cap (48 iterations)
MESHES = {"periodic": ("periodic-square", 1, 2, 0.1),
          "inline": ("inline-quad", 0, 2, 0.1),
          "inline-smooth": ("inline-quad", 1, 1, 0.0)}


def _close(got, want, tol):
    got = got.double().numpy()
    want = np.asarray(want, np.float64)
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert err <= tol * scale, (err, scale)


def _operators(mesh, rs, p, noise, mono_type, si, problem=4):
    jd = jbuild(jload(mesh, rs), p)
    td = build_discretization(load_mesh(mesh, rs), p)
    kw = dict(problem=problem, ho=0, lo=0, fct=0, mono=mono_type,
              smth_ind=si, pa=False)
    jadv = JAdvection(jd, JSolverConfig(**kw), jnp.asarray(jd.mesh.x))
    tadv = Advection(td, SolverConfig(**kw), td.mesh.x,
                     dtype=torch.float64, device="cpu")
    x = np.einsum("end,mn->emd", jd.mesh.x, jd.Bm_at_unodes)
    rng = np.random.default_rng(mono_type + 3 * si)
    u = np.exp(-3.0 * ((x - 0.2) ** 2).sum(-1)) + noise * rng.random(
        x.shape[:2])
    return jadv, tadv, u


def test_velocity_scale_matches_jax():
    for mesh, rs, _, _ in MESHES.values():
        for problem in (4, 5, 7):
            jm, tm = jload(mesh, rs), load_mesh(mesh, rs)
            want = jmono.velocity_scale(jm, jbuild(jm, 3), problem,
                                        jm.bb_min, jm.bb_max)
            got = mono.velocity_scale(tm, build_discretization(tm, 3),
                                      problem)
            np.testing.assert_allclose(got, want, rtol=1e-13, atol=0)


def test_nonlin_flux_lumping_matches_jax():
    rng = np.random.default_rng(4)
    E, nf, fd = 7, 4, 3
    args = (rng.random((E, nf, fd)), rng.random((E, nf, fd)),
            rng.random((E, nf, fd, fd)), rng.random((E, nf, fd)))
    for alpha in (args[3], np.ones((E, nf, fd))):
        a = args[:3] + (alpha,)
        _close(mono_lumping.nonlin_flux_lumping(*map(torch.as_tensor, a)),
               jmono.nonlin_flux_lumping(*map(jnp.asarray, a)), 1e-13)


@pytest.mark.parametrize("mesh,mono_type,si", [
    ("periodic", 1, 0), ("periodic", 2, 2), ("periodic", 1, 1),
    ("inline", 2, 0), ("inline", 1, 2), ("inline", 2, 1)])
def test_mono_rd_solution_matches_jax(mesh, mono_type, si):
    jadv, tadv, u = _operators(*MESHES[mesh], mono_type, si)
    dt = 0.005
    got = mono.mono_rd_solution(tadv, tadv.geometry(0.0),
                                torch.as_tensor(u), dt)
    want = jmono.mono_rd_solution(jadv, jadv.geometry(0.0), jnp.asarray(u),
                                  dt)
    _close(got, want, 1e-12)
    st = tadv.mono_stats
    assert st["solves"] == 1 and 1 <= st["iterations"] <= mono.MAX_ITER


def test_exit_test_interval_does_not_change_the_result(monkeypatch):
    _, tadv, u = _operators(*MESHES["inline-smooth"], 2, 0)
    geom, ut = tadv.geometry(0.0), torch.as_tensor(u)
    outs, stats = [], []
    for k in (1, 3, mono.CHECK_EVERY, mono.MAX_ITER + 5):
        monkeypatch.setattr(mono, "CHECK_EVERY", k)
        tadv.mono_stats = dict(explicit=0, solves=0, iterations=0,
                               max_iterations=0, readbacks=0)
        outs.append(mono.mono_rd_solution(tadv, geom, ut, 0.005))
        stats.append(dict(tadv.mono_stats, k=k))
    for o in outs[1:]:
        assert torch.equal(o, outs[0])
    needed = stats[0]["iterations"]
    assert needed < mono.MAX_ITER and stats[0]["readbacks"] == needed
    for st in stats:
        k = st["k"]
        it = min(-(-needed // k) * k, mono.MAX_ITER)
        assert st["iterations"] == it
        assert st["readbacks"] == -(-it // k)
