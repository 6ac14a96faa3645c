"""remhos_torch.ops.stage_ho_nodes against remhos_tpu's fused_stage_ho on the
CPU.

The JAX side runs the Pallas kernel `fused_stage_ho` in interpret mode, as
tests/test_foundations.py:174-211 does; the port runs the plain PyTorch
version `stage_ho_nodes_reference` through the wrapper (CPU tensors). Both
get the same numpy inputs from a seed: the nodes of a Cartesian mesh (3D
4^3, 2D 6x6, p=3, mesh order 2) moved by a smooth field, a random nodal
velocity, a random u and its face-neighbour trace. Tolerances, relative to
the largest entry of the JAX result:
- du_HO (Ku with n_cg == 0): 1e-9 in f64, the JAX package's own
  Pallas-vs-XLA bar (tests/test_foundations.py:202); 2e-3 in f32, its
  kernel's f32 products against the port's true f32 products;
- wdet: 1e-13 in f64 (sums of a few dozen O(1) products), 1e-5 in f32; and
  against the port's `wdet_reference`, which takes det J by another
  cofactor expansion, to the same limits.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from remhos_tpu import structured as jstr
from remhos_tpu.discretization import build_discretization as jbuild
from remhos_tpu.mesh import make_cartesian_mesh as jmesh
from remhos_tpu.ops import pallas_kernels as pk

from remhos_torch import convert
from remhos_torch.discretization import build_discretization
from remhos_torch.mesh import make_cartesian_mesh
from remhos_torch.ops import stage_ho_nodes as shn
from remhos_torch.ops import wdet as wd

PREC = {torch.float64: (jnp.float64, 1e-9, 1e-13),
        torch.float32: (jnp.float32, 2e-3, 1e-5)}
SHAPES = [(4, 4, 4), (6, 6)]
_CACHE = {}


def _setup(shape):
    """Both packages' discretizations and the seeded numpy inputs."""
    if shape in _CACHE:
        return _CACHE[shape]
    dim = len(shape)
    args = (dim, shape, (0.0,) * dim, (1.0,) * dim, (False,) * dim, 2)
    jd = jbuild(jmesh(*args), 3)
    td = build_discretization(make_cartesian_mesh(*args), 3)
    rng = np.random.default_rng(sum(shape))
    x0 = jd.mesh.x
    xs = x0 + 0.05 * np.sin(3.0 * x0[..., ::-1])
    v = rng.standard_normal(x0.shape)
    E = x0.shape[0]
    u = rng.standard_normal((E, jd.nd))
    unbr = np.asarray(jstr.gather_nbr_structured(
        jnp.asarray(u), shape, (False,) * dim,
        np.asarray(jd.dofmaps.nbr_dof_local))).reshape(E, -1)
    _CACHE[shape] = (jd, td, xs, v, u, unbr)
    return _CACHE[shape]


def _rel(a, b):
    b = np.asarray(b, np.float64)
    return np.abs(np.asarray(a, np.float64) - b).max() / np.abs(b).max()


def _both(shape, dtype, **kw):
    jd, td, xs, v, u, unbr = _setup(shape)
    jdt = PREC[dtype][0]
    J = lambda a: jnp.asarray(a, jdt)                   # noqa: E731
    du_j, wdet_j = pk.fused_stage_ho(J(xs), J(v), J(u), J(unbr),
                                     pk.stage_ho_tables(jd, jdt),
                                     interpret=True, **kw)
    tables = shn.stage_ho_nodes_tables(td, dtype, "cpu")
    t = lambda a: convert.tensor(a, dtype)              # noqa: E731
    before = shn.stage_ho_nodes.launches
    du_t, wdet_t = shn.stage_ho_nodes(t(xs), t(v), t(u), t(unbr), tables,
                                      **kw)
    assert shn.stage_ho_nodes.launches == before    # CPU: the plain version
    assert du_t.dtype == wdet_t.dtype == dtype
    assert tuple(du_t.shape) == u.shape
    assert tuple(wdet_t.shape) == (u.shape[0], len(jd.w_q))
    return (du_j, wdet_j), (du_t, wdet_t), td, xs


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("n_cg", [None, 0, 3])
@pytest.mark.parametrize("with_face", [True, False])
@pytest.mark.parametrize("mode", [1.0, -1.0])
def test_stage_ho_nodes_f64(shape, n_cg, with_face, mode):
    (du_j, wdet_j), (du_t, wdet_t), td, xs = _both(
        shape, torch.float64, mode=mode, n_cg=n_cg, with_face=with_face)
    _, tol, wtol = PREC[torch.float64]
    assert _rel(du_t, du_j) <= tol
    assert np.abs(np.asarray(wdet_t) - np.asarray(wdet_j)).max() <= wtol
    ref = wd.wdet_reference(convert.tensor(xs),
                            wd.wdet_tables(td, torch.float64, "cpu"))
    assert _rel(wdet_t, ref) <= wtol


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("n_cg,with_face,mode", [(None, True, 1.0),
                                                 (0, True, -1.0),
                                                 (3, False, 1.0)])
def test_stage_ho_nodes_f32(shape, n_cg, with_face, mode):
    (du_j, wdet_j), (du_t, wdet_t), _, _ = _both(
        shape, torch.float32, mode=mode, n_cg=n_cg, with_face=with_face)
    _, tol, wtol = PREC[torch.float32]
    assert _rel(du_t, du_j) <= tol
    assert _rel(wdet_t, wdet_j) <= wtol


def test_face_flux_and_sweeps_matter():
    """The options change the result (a check of the checks): the face flux
    and the mass inverse are not negligible at this size."""
    _, (du, _), _, _ = _both((4, 4, 4), torch.float64, mode=1.0)
    _, (du_nf, _), _, _ = _both((4, 4, 4), torch.float64, mode=1.0,
                                with_face=False)
    _, (ku, _), _, _ = _both((4, 4, 4), torch.float64, mode=1.0, n_cg=0)
    assert _rel(du_nf, du) > 1e-3
    assert _rel(ku, du) > 1e-1


def test_stage_ho_nodes_refuses_bad_operands():
    jd, td, xs, v, u, unbr = _setup((6, 6))
    t = convert.tensor
    tables = shn.stage_ho_nodes_tables(td, torch.float64, "cpu")
    with pytest.raises(ValueError, match="mode"):
        shn.stage_ho_nodes(t(xs), t(v), t(u), t(unbr), tables, mode=0.5)
    with pytest.raises(ValueError, match="n_cg"):
        shn.stage_ho_nodes(t(xs), t(v), t(u), t(unbr), tables, mode=1,
                           n_cg=-1)
    with pytest.raises(TypeError, match="must be torch.float64"):
        shn.stage_ho_nodes(t(xs), t(v, torch.float32), t(u), t(unbr),
                           tables, mode=1)
    with pytest.raises(ValueError, match="u_nbr must be"):
        shn.stage_ho_nodes(t(xs), t(v), t(u), t(unbr)[:, :-1], tables,
                           mode=1)
    with pytest.raises(ValueError, match="xs must be"):
        shn.stage_ho_nodes(t(xs)[..., :1], t(v), t(u), t(unbr), tables,
                           mode=1)
