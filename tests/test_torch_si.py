"""remhos_torch.si (the smoothness indicator, `-si 1|2`) and
structured._shift against remhos_tpu on the CPU.

The same seeded numpy field goes through both packages' indicator on the
same mesh: 2D and 3D, periodic and not. In f64 every action and the
indicator of both types equal the JAX package's to 1e-12 of the largest
entry (the same formulas; the fine-grid sums in another, fixed, order).
The JAX package's indicator tables are f64 whatever the run's dtype, so it
evaluates an f32 field in f64; the port's f32 indicator stays f32 and is
held to that to 1e-4, and is finite on a field that is exactly flat over
most of the mesh, where type 1's reference eps (1e-50) is 0 in f32.

The driver runs are in tests/test_torch_si_driver.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from remhos_tpu import structured as jstr
from remhos_tpu.discretization import build_discretization as jbuild
from remhos_tpu.mesh import make_cartesian_mesh as jmesh
from remhos_tpu.si import SmoothnessIndicator as JSI

from remhos_torch import structured
from remhos_torch.discretization import build_discretization
from remhos_torch.mesh import make_cartesian_mesh
from remhos_torch.si import SmoothnessIndicator, fine_node_gather
from torch_threads import one_torch_thread  # noqa: F401

MESHES = {"2d-periodic": ((6, 5), 3, True), "2d": ((4, 3), 3, False),
          "3d-periodic": ((3, 3, 2), 2, True), "3d": ((2, 2, 3), 2, False)}


def _discs(shape, p, periodic):
    dim = len(shape)
    args = (dim, shape, (-1.0,) * dim, (1.0,) * dim, (periodic,) * dim)
    return jbuild(jmesh(*args), p), build_discretization(
        make_cartesian_mesh(*args), p)


def _field(jd, seed=3):
    """A smooth bump plus noise at the Bernstein dofs."""
    rng = np.random.default_rng(seed)
    x = np.einsum("end,mn->emd", jd.mesh.x, jd.Bm_at_unodes)
    return np.exp(-4.0 * (x ** 2).sum(-1)) + 0.05 * rng.random(x.shape[:2])


def _close(got, want, tol):
    got = got.double().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert err <= tol * max(scale, 1e-300), (err, scale)


@pytest.fixture(scope="module", params=list(MESHES))
def pair(request):
    shape, p, periodic = MESHES[request.param]
    jd, td = _discs(shape, p, periodic)
    return jd, td, _field(jd)


@pytest.mark.parametrize("si_type", [1, 2])
def test_compute_matches_jax(pair, si_type):
    jd, td, u = pair
    js = JSI(si_type, jd, jd.mesh.bb_min, jd.mesh.bb_max)
    ts = SmoothnessIndicator(si_type, td, torch.float64, "cpu")
    got = ts.compute(torch.as_tensor(u))
    want = js.compute(jnp.asarray(u))
    _close(got, want, 1e-12)
    _close(ts.dof_values(got), js.dof_values(want), 1e-12)


def test_actions_match_jax(pair):
    """The lumped mass, the block actions, the Neumann projection and the
    stencil min/max on a random fine-grid vector."""
    jd, td, _ = pair
    js = JSI(1, jd, jd.mesh.bb_min, jd.mesh.bb_max)
    ts = SmoothnessIndicator(1, td, torch.float64, "cpu")
    _close(ts.lumped, js.lumped, 1e-14)
    y = np.random.default_rng(7).standard_normal(ts.n_cg)
    yt, yj = torch.as_tensor(y), jnp.asarray(y)
    _close(ts._apply_blocks(ts.Msub, yt), js._apply_blocks(js.Msub, yj),
           1e-13)
    _close(ts._apply_blocks(ts.Lop, yt), js._apply_blocks(js.Lop, yj),
           1e-13)
    _close(ts._neumann_project(yt), js._neumann_project(yj), 1e-13)
    for got, want in zip(ts._stencil_minmax(yt), js._stencil_minmax(yj)):
        _close(got, want, 0.0)


def test_update_bounds_matches_jax(pair):
    jd, td, u = pair
    rng = np.random.default_rng(11)
    si = rng.random(u.shape)
    u_new = u + 0.1 * rng.standard_normal(u.shape)
    lo, hi = u - 0.2 * rng.random(u.shape), u + 0.2 * rng.random(u.shape)
    js = JSI(2, jd, jd.mesh.bb_min, jd.mesh.bb_max)
    ts = SmoothnessIndicator(2, td, torch.float64, "cpu")
    got = ts.update_bounds(*map(torch.as_tensor, (u_new, lo, hi, si)))
    want = js.update_bounds(*map(jnp.asarray, (u_new, lo, hi, si)))
    for g, w in zip(got, want):
        _close(g, w, 0.0)


def test_fine_node_gather_sums_like_a_scatter():
    """Each fine node gathers exactly the corner contributions a scatter-add
    puts there, in ascending order, at most 2^dim of them."""
    for shape, p, periodic in MESHES.values():
        _, td = _discs(shape, p, periodic)
        ts = SmoothnessIndicator(2, td, torch.float64, "cpu")
        corner = ts.corner_cg.numpy()
        idx = fine_node_gather(corner, ts.n_cg)
        assert idx.shape[1] == 2 ** len(shape)
        vals = np.random.default_rng(1).standard_normal(corner.size)
        want = np.zeros(ts.n_cg)
        np.add.at(want, corner.reshape(-1), vals)
        got = np.append(vals, 0.0)[idx].sum(1)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-14)
        pad = idx == corner.size
        assert (np.diff(np.where(pad, -1, idx), axis=1)[~pad[:, 1:]]
                > 0).all()


def test_shift_matches_jax():
    a = np.random.default_rng(2).standard_normal((3, 4, 5))
    slab = np.arange(12.0).reshape(3, 4, 1)
    for gdim in range(3):
        for side in (0, 1):
            for per in (True, False):
                _close(structured._shift(torch.as_tensor(a), gdim, side, per,
                                         fill=-7.0),
                       jstr._shift(jnp.asarray(a), gdim, side, per,
                                   fill=-7.0), 0.0)
            if gdim == 2:
                _close(structured._shift(torch.as_tensor(a), gdim, side,
                                         True,
                                         edge_slab=torch.as_tensor(slab)),
                       jstr._shift(jnp.asarray(a), gdim, side, True,
                                   edge_slab=jnp.asarray(slab)), 0.0)


@pytest.mark.parametrize("si_type", [1, 2])
def test_f32_indicator(si_type):
    """f32 against the JAX package's indicator (evaluated in f64 there),
    on a field that is exactly 0 outside a few elements: finite, and 1e-4
    from it."""
    jd, td = _discs((8, 8), 3, True)
    u = _field(jd)
    u[8:] = 0.0
    js = JSI(si_type, jd, jd.mesh.bb_min, jd.mesh.bb_max)
    ts = SmoothnessIndicator(si_type, td, torch.float32, "cpu")
    got = ts.compute(torch.as_tensor(u, dtype=torch.float32))
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    _close(got, js.compute(jnp.asarray(u, jnp.float32)), 1e-4)
