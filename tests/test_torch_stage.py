"""The limited stage of remhos_torch against remhos_tpu on the CPU.

The JAX side runs its Pallas mega kernel in interpret mode, as
tests/test_foundations.py does. The port's side runs the plain PyTorch
version of its CUDA kernel (the wrapper takes it for CPU tensors). Both get
the same numpy inputs, carried into the port's layout by
remhos_torch.convert. Tolerances:
- mass_based_avg and clip_scale: <= 1e-13 * scale (same formulas);
- plain version vs the JAX mega kernel: <= 1e-10 * max|du| in f64; in f32
  <= 2e-3 * max|du|, the JAX f32 kernel's bf16x3 products against true f32
  products (the f32 input floor is ~7e-4 per HO solve, bench.py:400);
- plain version vs the JAX XLA composition (use_pallas=False): <= 1e-9 *
  scale, the JAX package's own Pallas-vs-XLA bar (test_foundations.py:235).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from remhos_tpu import bounds as jbnd
from remhos_tpu import fct as jfct
from remhos_tpu import lo as jlo
from remhos_tpu import structured as jstr
from remhos_tpu.discretization import build_discretization as jbuild
from remhos_tpu.mesh import make_cartesian_mesh as jmesh
from remhos_tpu.operator import Advection as JAdvection
from remhos_tpu.operator import SolverConfig as JConfig
from remhos_tpu.ops import pallas_kernels as pk

from remhos_torch import convert, fct, lo
from remhos_torch.discretization import build_discretization
from remhos_torch.mesh import make_cartesian_mesh
from remhos_torch.operator import Advection, SolverConfig
from remhos_torch.ops import mega_stage as ms

T_STAGE, DT = 0.3, 0.01


def _max_err(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max(), np.abs(b).max()


def _setup(shape, seed):
    dim = len(shape)
    args = (dim, shape, (0.0,) * dim, (1.0,) * dim, (False,) * dim)
    jd = jbuild(jmesh(*args), 3)
    td = build_discretization(make_cartesian_mesh(*args), 3)
    rng = np.random.default_rng(seed)
    x0 = jd.mesh.x
    v = 0.1 * np.sin(x0)
    u = rng.random((jd.mesh.num_elements, jd.nd))
    return jd, td, x0, v, u


def _jax_inputs(jd, x0, v, u, jdt):
    """u, u_nbr, class-major stencil, P and tables of the JAX mega stage."""
    m = jd.mesh
    uj = jnp.asarray(u, jdt)
    lo_, hi_ = jbnd.elements_min_max(uj)
    smin, smax = jstr.overlap_stencil_T(lo_, hi_, m.shape, m.periodic)
    unbr = jstr.gather_nbr_structured(uj, m.shape, m.periodic,
                                      jd.dofmaps.nbr_dof_local)
    unbr = unbr.reshape(m.num_elements, -1)
    tb = pk.stage_ho_tables(jd, jdt)
    P = pk.build_poly_tables(jnp.asarray(x0, jdt), jnp.asarray(v, jdt),
                             jd)["P"]
    return uj, unbr, smin, smax, P, tb


def _port_inputs(jd, tb, P, uj, unbr, smin, smax, dtype):
    nf, Qf = jd.n_ref.shape[0], jd.Bface.shape[0]
    ttb = convert.stage_tables(tb, convert.discretization_tables(jd), dtype)
    Pt = convert.poly(P, jd.dim, tb["Q"], nf * Qf, tb["seg"], dtype)
    c = lambda a: convert.tensor(a, dtype)
    return c(uj), c(unbr), c(smin), c(smax), Pt, ttb


@pytest.mark.parametrize("shape", [(4, 3, 2), (6, 4)])
def test_lo_and_clip_scale(shape):
    jd, td, x0, v, u = _setup(shape, 11)
    rng = np.random.default_rng(12)
    E, nd, Q = u.shape[0], jd.nd, len(jd.w_q)
    du_ho = rng.standard_normal((E, nd))
    detJ = 0.5 + rng.random((E, Q))
    jl = jlo.mass_based_avg(jnp.asarray(u), jnp.asarray(du_ho), DT,
                            jnp.asarray(detJ), jnp.asarray(jd.w_q),
                            jnp.asarray(jd.Bu))
    t = convert.tensor
    tl = lo.mass_based_avg(t(u), t(du_ho), DT, t(detJ), t(td.w_q), t(td.Bu))
    err, scale = _max_err(tl, jl)
    assert err <= 1e-13 * scale
    m = rng.random((E, nd)) + 0.1
    du_lo = np.asarray(jl)
    umin = u - rng.random((E, nd))
    umax = u + rng.random((E, nd))
    jc = jfct.clip_scale(*(jnp.asarray(a) for a in
                           (u, m, du_ho, du_lo, umin, umax)), DT)
    tc = fct.clip_scale(*(t(a) for a in (u, m, du_ho, du_lo, umin, umax)),
                        DT)
    err, scale = _max_err(tc, jc)
    assert err <= 1e-13 * scale


@pytest.mark.parametrize("shape", [(4, 3, 2), (6, 4)])
@pytest.mark.parametrize("prec", ["f64", "f32"])
def test_reference_matches_jax_mega_kernel(shape, prec):
    jdt, dtype, tol = {"f64": (jnp.float64, torch.float64, 1e-10),
                       "f32": (jnp.float32, torch.float32, 2e-3)}[prec]
    jd, td, x0, v, u = _setup(shape, 21)
    uj, unbr, smin, smax, P, tb = _jax_inputs(jd, x0, v, u, jdt)
    du_j = pk.fused_stage_mega_poly(T_STAGE, DT, uj, unbr, smin, smax,
                                    {"P": P}, tb, dim=jd.dim, mode=1.0,
                                    interpret=True, bounds_stencil="T")
    ut, unt, smt, sxt, Pt, ttb = _port_inputs(jd, tb, P, uj, unbr, smin,
                                              smax, dtype)
    before = ms.mega_stage.launches
    du_t = ms.mega_stage(T_STAGE, DT, ut, unt, smt, sxt, Pt, ttb)
    assert ms.mega_stage.launches == before     # CPU: plain version only
    assert du_t.dtype == dtype and du_t.shape == tuple(uj.shape)
    err, scale = _max_err(du_t, du_j)
    assert err <= tol * scale, err / scale


@pytest.mark.parametrize("shape", [(4, 3, 2), (6, 4)])
def test_stage_matches_jax_xla_composition(shape):
    """The port's whole stage (its own tables, P and glue) against the JAX
    XLA composition, in f64."""
    jd, td, x0, v, u = _setup(shape, 31)
    jadv = JAdvection(jd, JConfig(problem=10, ho=3, lo=5, fct=2, pa=True),
                      jnp.asarray(x0), jnp.asarray(v), None)
    dS, _ = jadv.stage_function()(T_STAGE, DT, jnp.stack([jnp.asarray(u)]))
    adv = Advection(td, SolverConfig(), x0, v, dtype=torch.float64,
                    device="cpu")
    dSt, aux = adv.stage_function()(T_STAGE, DT, convert.tensor(u)[None])
    assert aux is None and dSt.shape == (1,) + u.shape      # the mega path
    err, scale = _max_err(dSt[0], dS[0])
    assert err <= 1e-9 * scale


def test_wrapper_rejects_bad_inputs():
    jd, td, x0, v, u = _setup((4, 3, 2), 41)
    adv = Advection(td, SolverConfig(), x0, v, dtype=torch.float64,
                    device="cpu")
    ut = convert.tensor(u)
    unbr = adv.gather_nbr(ut).reshape(ut.shape[0], -1)
    s = torch.zeros(27, ut.shape[0], dtype=torch.float64)
    args = (unbr, s, s, adv._poly, adv._stage_tables)
    with pytest.raises(TypeError):
        ms.mega_stage(0.0, DT, ut.float(), *args)
    with pytest.raises(TypeError):
        ms.mega_stage(0.0, DT, ut.to(torch.float16), *args)
    with pytest.raises(ValueError):
        ms.mega_stage(0.0, DT, ut[:, :10], *args)
    with pytest.raises(ValueError):
        ms.mega_stage(0.0, DT, ut, unbr[:, :10], s, s, adv._poly,
                      adv._stage_tables)
    with pytest.raises(ValueError):
        ms.mega_stage(0.0, DT, ut, unbr, s[:9], s, adv._poly,
                      adv._stage_tables)
