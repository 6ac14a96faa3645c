"""remhos_torch.ops.geom_conv against remhos_tpu's fused_geom_conv on the
CPU.

Same numpy inputs on both sides: the nodes of a Cartesian mesh moved by a
smooth field, a random nodal velocity and a random u. The JAX side is the
Pallas kernel in interpret mode (Ku and wdet) and, as a second witness, the
XLA composition `volume_detj_va` + `pa.conv_action`. The port runs on CPU
tensors, i.e. the plain version `geom_conv_reference`, through the wrapper.
Tolerances, relative to the largest entry of the JAX result: f64 1e-12 (the
same sums in another order; the JAX package's own check is 1e-14 absolute at
4^3, tests/test_foundations.py:165), f32 1e-5 (a few hundred f32 roundings
of O(1) terms).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from remhos_tpu import geometry as jgeo
from remhos_tpu import pa as jpa
from remhos_tpu.discretization import build_discretization as jbuild
from remhos_tpu.mesh import make_cartesian_mesh as jmesh
from remhos_tpu.ops import pallas_kernels as pk

from remhos_torch import convert
from remhos_torch.discretization import build_discretization
from remhos_torch.mesh import make_cartesian_mesh
from remhos_torch.ops import geom_conv as gc

TOL = {torch.float64: 1e-12, torch.float32: 1e-5}
JDT = {torch.float64: jnp.float64, torch.float32: jnp.float32}
# (shape, p, mesh order)
CASES = [((4, 4, 4), 3, 2), ((3, 2, 2), 2, 1), ((2, 2, 2), 3, 3),
         ((6, 6), 3, 2), ((4, 3), 2, 1), ((3, 3), 3, 3)]


def _inputs(shape, p, mesh_order, seed):
    dim = len(shape)
    args = (dim, shape, (0.0,) * dim, (1.0,) * dim, (False,) * dim,
            mesh_order)
    jd = jbuild(jmesh(*args), p)
    td = build_discretization(make_cartesian_mesh(*args), p)
    rng = np.random.default_rng(seed)
    x0 = jd.mesh.x
    xs = x0 + 0.05 * np.sin(3.0 * x0[..., ::-1])        # a curved mesh
    v = rng.standard_normal(x0.shape)
    u = rng.random((x0.shape[0], jd.nd))
    return jd, td, xs, v, u


def _rel(a, b):
    b = np.asarray(b, np.float64)
    return np.abs(np.asarray(a, np.float64) - b).max() / np.abs(b).max()


@pytest.mark.parametrize("shape,p,mesh_order", CASES)
@pytest.mark.parametrize("sign", [1.0, -1.0])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_geom_conv_matches_pallas_kernel(shape, p, mesh_order, sign, dtype):
    jd, td, xs, v, u = _inputs(shape, p, mesh_order, 1)
    J = lambda a: jnp.asarray(a, JDT[dtype])          # noqa: E731
    Kj, wj = pk.fused_geom_conv(J(xs), J(v), J(u), jd, sign, block_e=8)
    tables = gc.geom_conv_tables(td, dtype, "cpu")
    before = gc.geom_conv.launches
    Kt, wt = gc.geom_conv(convert.tensor(xs, dtype), convert.tensor(v, dtype),
                          convert.tensor(u, dtype), tables, sign)
    assert gc.geom_conv.launches == before      # CPU: the plain version
    assert Kt.dtype == wt.dtype == dtype
    assert tuple(Kt.shape) == u.shape
    assert tuple(wt.shape) == (u.shape[0], jd.w_q.shape[0])
    assert _rel(Kt, Kj) <= TOL[dtype]
    assert _rel(wt, wj) <= TOL[dtype]


@pytest.mark.parametrize("shape,p,mesh_order", CASES[:1] + CASES[3:4])
def test_geom_conv_matches_conv_action(shape, p, mesh_order):
    """The XLA composition of the JAX package: va from volume_detj_va, then
    pa.conv_action; and the port's own conv_action on the same va."""
    from remhos_torch import pa
    jd, td, xs, v, u = _inputs(shape, p, mesh_order, 2)
    v_q = jgeo.interp_nodes(jnp.asarray(v), jnp.asarray(jd.Bm))
    detJ, va = jgeo.volume_detj_va(jnp.asarray(xs), jnp.asarray(jd.Gm), v_q,
                                   1.0)
    Bu_w = jd.Bu * jd.w_q[:, None]
    Kj = jpa.conv_action(jnp.asarray(u), va, jnp.asarray(jd.Gu),
                         jnp.asarray(Bu_w))
    t = convert.tensor
    tables = gc.geom_conv_tables(td, torch.float64, "cpu")
    Kt, wt = gc.geom_conv(t(xs), t(v), t(u), tables, 1.0)
    assert _rel(Kt, Kj) <= 1e-12
    assert _rel(wt, jd.w_q[None, :] * np.asarray(detJ)) <= 1e-12
    Kc = pa.conv_action(t(u), t(va), t(td.Gu), t(Bu_w))
    assert _rel(Kc, Kj) <= 1e-12


def test_geom_conv_refuses_bad_operands():
    jd, td, xs, v, u = _inputs((2, 2), 2, 1, 3)
    t = convert.tensor
    tables = gc.geom_conv_tables(td, torch.float64, "cpu")
    with pytest.raises(TypeError, match="float32 or float64"):
        gc.geom_conv(t(xs).to(torch.float16), t(v), t(u), tables, 1.0)
    with pytest.raises(TypeError, match="must be torch.float64"):
        gc.geom_conv(t(xs), t(v, torch.float32), t(u), tables, 1.0)
    with pytest.raises(ValueError, match="u must be"):
        gc.geom_conv(t(xs), t(v), t(u)[:, :-1], tables, 1.0)
    with pytest.raises(ValueError, match="xs must be"):
        gc.geom_conv(t(xs)[..., :1], t(v), t(u), tables, 1.0)
    other = gc.geom_conv_tables(build_discretization(td.mesh, 3),
                                torch.float64, "cpu")
    with pytest.raises(ValueError, match="must be"):
        gc.geom_conv(t(xs), t(v), t(u), other, 1.0)
