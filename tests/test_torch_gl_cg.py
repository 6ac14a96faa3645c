"""remhos_torch.ops.gl_cg against remhos_tpu's fused_gl_cg on the CPU.

The JAX side runs the Pallas kernel `fused_gl_cg` in interpret mode (its
default is interpret=False, unlike the other kernels': the tests pass it);
the port runs the plain PyTorch version `gl_cg_reference` through the
wrapper (CPU tensors). Same numpy inputs from a seed: a random right-hand
side and wdet = w_q det J of a Cartesian mesh (3D 4^3, 2D 6x6, p=3) whose
elements are curved by a smooth field, except a checkerboard of affine
ones. An affine element has a diagonal GL mass matrix and stops after one
iteration, a curved one after several: the per-element masks stop elements
at different iterations. One element has a zero right-hand side, which
never starts (the zero guards). Tolerances, relative to the largest entry
of the JAX result: 1e-9 in f64 (the JAX package's own bar,
tests/test_foundations.py:202), 2e-3 in f32; the mass-action residual
below 1e-7 of max|rhs| in f64 (tests/test_foundations.py:170-171).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from remhos_tpu.discretization import build_discretization as jbuild
from remhos_tpu.mesh import make_cartesian_mesh as jmesh
from remhos_tpu.ops import pallas_kernels as pk

from remhos_torch import convert, pa
from remhos_torch.discretization import build_discretization
from remhos_torch.mesh import make_cartesian_mesh
from remhos_torch.ops import gl_cg as cg
from remhos_torch.ops import tables as tbl
from remhos_torch.ops import wdet as wd

PREC = {torch.float64: (jnp.float64, 1e-9), torch.float32: (jnp.float32,
                                                             2e-3)}
SHAPES = [(4, 4, 4), (6, 6)]
_CACHE = {}


def _setup(shape):
    if shape in _CACHE:
        return _CACHE[shape]
    dim = len(shape)
    args = (dim, shape, (0.0,) * dim, (1.0,) * dim, (False,) * dim, 2)
    jd = jbuild(jmesh(*args), 3)
    td = build_discretization(make_cartesian_mesh(*args), 3)
    x0 = jd.mesh.x
    E = x0.shape[0]
    idx = np.indices(shape).reshape(dim, -1)       # grid coordinates
    curved = (idx.sum(axis=0) % 2 == 0).astype(float)
    # element e = ix + nx iy (+ nx ny iz): np.indices is C-ordered
    curved = curved.reshape(shape).transpose().reshape(E)
    # not separable in the axes: det J of degree 2 along an axis (a shear
    # or an axis-wise bend leaves the GL mass matrix diagonal)
    bend = 0.1 / shape[0] * np.sin(7.3 * x0.sum(axis=-1, keepdims=True)
                                    + 0.4 + np.arange(dim))
    xs = x0 + curved[:, None, None] * bend
    wdet = np.asarray(wd.wdet_reference(
        convert.tensor(xs), wd.wdet_tables(td, torch.float64, "cpu")))
    rng = np.random.default_rng(sum(shape) + 5)
    rhs = rng.standard_normal((E, jd.nd))
    rhs[1] = 0.0
    _CACHE[shape] = (jd, td, wdet, rhs, curved)
    return _CACHE[shape]


def _rel(a, b):
    b = np.asarray(b, np.float64)
    return np.abs(np.asarray(a, np.float64) - b).max() / np.abs(b).max()


def _both(shape, dtype, n_iter=16):
    jd, td, wdet, rhs, _ = _setup(shape)
    jdt, _ = PREC[dtype]
    out_j = pk.fused_gl_cg(jnp.asarray(rhs, jdt), jnp.asarray(wdet, jdt), jd,
                           n_iter=n_iter, interpret=True)
    tables = tbl.stage_ho_tables(td, dtype, "cpu")
    before = cg.gl_cg.launches
    out_t = cg.gl_cg(convert.tensor(rhs, dtype), convert.tensor(wdet, dtype),
                     tables, n_iter=n_iter)
    assert cg.gl_cg.launches == before          # CPU: the plain version
    assert out_t.dtype == dtype and tuple(out_t.shape) == rhs.shape
    return np.asarray(out_j), out_t, td


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("n_iter", [16, 2])
def test_gl_cg_matches_pallas_kernel(shape, dtype, n_iter):
    """n_iter=2 stops the curved elements before they converge: the result
    then depends on the masking semantics, and both agree there too."""
    out_j, out_t, _ = _both(shape, dtype, n_iter)
    assert _rel(out_t, out_j) <= PREC[dtype][1]
    assert float(out_t[1].abs().max()) == 0.0


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_gl_cg_solves_the_mass_matrix(shape):
    jd, td, wdet, rhs, _ = _setup(shape)
    t = convert.tensor
    out = cg.gl_cg(t(rhs), t(wdet), tbl.stage_ho_tables(td, torch.float64,
                                                        "cpu"))
    resid = pa.mass_action(out, t(wdet), t(jd.Bu)) - t(rhs)
    assert float(resid.abs().max()) <= 1e-7 * np.abs(rhs).max()


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_elements_stop_at_different_iterations(shape):
    """Affine elements are frozen after one iteration, bit for bit; curved
    ones still move between 2 and 4 iterations, and the global CG of
    pa.mass_solve_gl on the same system agrees with the converged result."""
    jd, td, wdet, rhs, curved = _setup(shape)
    t = convert.tensor
    tables = tbl.stage_ho_tables(td, torch.float64, "cpu")
    outs = {k: cg.gl_cg(t(rhs), t(wdet), tables, n_iter=k)
            for k in (1, 2, 4, 16)}
    flat = torch.as_tensor(curved == 0.0)
    assert torch.equal(outs[1][flat], outs[16][flat])
    moved = (outs[4] - outs[2]).abs().amax(dim=1)
    assert bool((moved[~flat] > 0).all())
    ref = pa.mass_solve_gl(t(rhs), t(wdet), t(jd.Bgl), t(jd.A_gl2b))
    assert _rel(outs[16], ref) <= 1e-9


def test_gl_cg_refuses_bad_operands():
    jd, td, wdet, rhs, _ = _setup((6, 6))
    t = convert.tensor
    tables = tbl.stage_ho_tables(td, torch.float64, "cpu")
    with pytest.raises(TypeError, match="float32 or float64"):
        cg.gl_cg(t(rhs).to(torch.float16), t(wdet), tables)
    with pytest.raises(TypeError, match="must be torch.float64"):
        cg.gl_cg(t(rhs), t(wdet, torch.float32), tables)
    with pytest.raises(ValueError, match="wdet must be"):
        cg.gl_cg(t(rhs), t(wdet)[:, :-1], tables)
    with pytest.raises(ValueError, match="n_iter"):
        cg.gl_cg(t(rhs), t(wdet), tables, n_iter=-1)
