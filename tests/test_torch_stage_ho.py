"""The HO stage and wdet of remhos_torch against remhos_tpu on the CPU.

The JAX side runs its Pallas kernels `fused_stage_ho_poly` and `fused_wdet`
in interpret mode, as tests/test_foundations.py does. The port's side runs
the plain PyTorch versions of its CUDA kernels (the wrappers take them for
CPU tensors). Both get the same numpy inputs, carried into the port's layout
by remhos_torch.convert. Tolerances:
- du_HO, du_LO (and Ku with n_cg == 0): <= 1e-9 * max|du| in f64, the JAX
  package's own Pallas-vs-XLA bar; <= 2e-3 * max|du| in f32, the JAX f32
  kernel's bf16x3 products against true f32 products;
- the stage's wdet: <= 1e-12 * max|wdet| in f64 (the same Horner sums),
  <= 1e-5 * max|wdet| in f32;
- wdet_reference vs fused_wdet: <= 1e-13 (absolute; wdet is O(1e-2)), also
  at mesh orders 1 and 3 and on non-uniform break points (the tables take
  the node count from the mesh order, not from p).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from remhos_tpu import structured as jstr
from remhos_tpu.discretization import build_discretization as jbuild
from remhos_tpu.mesh import make_mesh_from_breaks as jmesh
from remhos_tpu.ops import pallas_kernels as pk

from remhos_torch import convert
from remhos_torch.discretization import build_discretization
from remhos_torch.mesh import make_mesh_from_breaks
from remhos_torch.ops import stage_ho as sh
from remhos_torch.ops import wdet as wd

T_STAGE, DT = 0.3, 0.01
PREC = {"f64": (jnp.float64, torch.float64, 1e-9, 1e-12),
        "f32": (jnp.float32, torch.float32, 2e-3, 1e-5)}


def _max_err(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max(), np.abs(b).max()


def _setup(shape, seed, mesh_order=2, uniform=True):
    dim = len(shape)
    rng = np.random.default_rng(seed)
    breaks = []
    for n in shape:
        b = np.linspace(0.0, 1.0, n + 1)
        if not uniform:
            b[1:-1] += 0.2 / n * (rng.random(n - 1) - 0.5)
        breaks.append(b)
    args = (dim, tuple(breaks), (False,) * dim, mesh_order)
    jd = jbuild(jmesh(*args), 3)
    td = build_discretization(make_mesh_from_breaks(*args), 3)
    x0 = jd.mesh.x
    v = 0.1 * np.sin(x0)
    u = rng.random((jd.mesh.num_elements, jd.nd))
    return jd, td, x0, v, u


def _inputs(jd, x0, v, u, jdt, dtype):
    """(JAX operands, the same in the port's layout)."""
    m = jd.mesh
    uj = jnp.asarray(u, jdt)
    unbr = jstr.gather_nbr_structured(
        uj, m.shape, m.periodic, jd.dofmaps.nbr_dof_local).reshape(
            m.num_elements, -1)
    tb = pk.stage_ho_tables(jd, jdt)
    P = pk.build_poly_tables(jnp.asarray(x0, jdt), jnp.asarray(v, jdt),
                             jd)["P"]
    nf, Qf = jd.n_ref.shape[0], jd.Bface.shape[0]
    ttb = convert.stage_tables(tb, convert.discretization_tables(jd), dtype)
    Pt = convert.poly(P, jd.dim, tb["Q"], nf * Qf, tb["seg"], dtype)
    return (uj, unbr, P, tb), (convert.tensor(uj, dtype),
                               convert.tensor(unbr, dtype), Pt, ttb)


@pytest.mark.parametrize("shape", [(4, 3, 2), (6, 4)])
@pytest.mark.parametrize("prec", ["f64", "f32"])
@pytest.mark.parametrize("with_lo", [True, False])
def test_reference_matches_jax_stage_ho(shape, prec, with_lo):
    jdt, dtype, tol, wtol = PREC[prec]
    jd, td, x0, v, u = _setup(shape, 21)
    (uj, unbr, P, tb), (ut, unt, Pt, ttb) = _inputs(jd, x0, v, u, jdt, dtype)
    res_j = pk.fused_stage_ho_poly(T_STAGE, uj, unbr, {"P": P}, tb,
                                   dim=jd.dim, mode=1.0, interpret=True,
                                   dt=DT, with_lo=with_lo)
    before = sh.stage_ho.launches
    res_t = sh.stage_ho(T_STAGE, ut, unt, Pt, ttb, dt=DT, with_lo=with_lo)
    assert sh.stage_ho.launches == before       # CPU: plain version only
    assert len(res_t) == len(res_j) == (3 if with_lo else 2)
    assert all(r.dtype == dtype for r in res_t)
    assert res_t[1].shape == (u.shape[0], tb["Q"])      # wdet, unpadded
    scale = np.abs(np.asarray(res_j[0], np.float64)).max()
    for k in (0, 2) if with_lo else (0,):
        err, _ = _max_err(res_t[k], res_j[k])
        assert err <= tol * scale, (k, err / scale)
    err, wscale = _max_err(res_t[1], res_j[1])
    assert err <= wtol * wscale, err / wscale


@pytest.mark.parametrize("shape", [(4, 3, 2), (6, 4)])
def test_n_cg_zero_returns_ku(shape):
    """n_cg == 0 gives Ku in place of du_HO, and as the LO output too."""
    jdt, dtype, tol, wtol = PREC["f64"]
    jd, td, x0, v, u = _setup(shape, 22)
    (uj, unbr, P, tb), (ut, unt, Pt, ttb) = _inputs(jd, x0, v, u, jdt, dtype)
    ku_j, wdet_j, lo_j = pk.fused_stage_ho_poly(
        T_STAGE, uj, unbr, {"P": P}, tb, dim=jd.dim, mode=1.0,
        interpret=True, dt=DT, with_lo=True, n_cg=0)
    ku_t, wdet_t, lo_t = sh.stage_ho(T_STAGE, ut, unt, Pt, ttb, n_cg=0,
                                     dt=DT, with_lo=True)
    err, scale = _max_err(ku_t, ku_j)
    assert err <= tol * scale
    assert torch.equal(lo_t, ku_t)
    np.testing.assert_array_equal(np.asarray(lo_j), np.asarray(ku_j))
    err, wscale = _max_err(wdet_t, wdet_j)
    assert err <= wtol * wscale
    # and it differs from the solved du_HO: the mass inverse is not a no-op
    du_t, _ = sh.stage_ho(T_STAGE, ut, unt, Pt, ttb)
    assert (du_t - ku_t).abs().max() > 1e-3 * du_t.abs().max()


def test_port_tables_match_converted_jax_tables():
    """The port's own stage tables and P (what the operator builds) equal
    the JAX tables carried over by convert, at mesh order 2 on non-uniform
    break points."""
    from remhos_torch.ops import tables as tbl
    jdt, dtype, _, _ = PREC["f64"]
    jd, td, x0, v, u = _setup((4, 3, 2), 23, uniform=False)
    _, (ut, unt, Pt, ttb) = _inputs(jd, x0, v, u, jdt, dtype)
    own = tbl.stage_ho_tables(td, dtype, "cpu")
    for k, a in ttb.items():
        if torch.is_tensor(a):
            assert torch.allclose(own[k], a, rtol=0, atol=1e-14), k
        else:
            assert own[k] == a, k
    P_own = tbl.build_poly_tables(convert.tensor(x0), convert.tensor(v), td)
    err, scale = _max_err(P_own, Pt)
    assert err <= 1e-13 * scale


@pytest.mark.parametrize("shape,mesh_order,uniform", [
    ((4, 3, 2), 2, True), ((6, 4), 2, True), ((3, 2, 2), 1, False),
    ((5, 4), 3, False), ((3, 3, 2), 2, False)])
def test_wdet_reference_matches_jax_fused_wdet(shape, mesh_order, uniform):
    jd, td, x0, v, u = _setup(shape, 31, mesh_order, uniform)
    xs = x0 + 0.37 * v
    wj = pk.fused_wdet(jnp.asarray(xs), jd, interpret=True)
    tables = wd.wdet_tables(td, torch.float64, "cpu")
    assert tables["GmT"].shape == ((mesh_order + 1) ** len(shape),
                                   len(shape), len(td.w_q))
    before = wd.wdet.launches
    wt = wd.wdet(convert.tensor(xs), tables)
    assert wd.wdet.launches == before           # CPU: plain version only
    err, _ = _max_err(wt, wj)
    assert wt.shape == tuple(wj.shape) and err <= 1e-13


def test_wdet_matches_stage_kernel_by_product():
    """The two sources of a stage's wdet agree: the HO stage's Horner
    polynomial at t and the wdet kernel's determinant at x0 + t v."""
    jd, td, x0, v, u = _setup((4, 3, 2), 32, uniform=False)
    from remhos_torch.ops import tables as tbl
    t = convert.tensor
    tb = tbl.stage_ho_tables(td, torch.float64, "cpu")
    P = tbl.build_poly_tables(t(x0), t(v), td)
    unbr = torch.zeros(u.shape[0], tb["nf"] * tb["fd"], dtype=torch.float64)
    _, wdet_stage = sh.stage_ho(T_STAGE, t(u), unbr, P, tb)
    wdet_nodes = wd.wdet(t(x0 + T_STAGE * v),
                         wd.wdet_tables(td, torch.float64, "cpu"))
    err, scale = _max_err(wdet_stage, wdet_nodes)
    assert err <= 1e-12 * scale


def test_wrappers_reject_bad_inputs():
    jd, td, x0, v, u = _setup((4, 3, 2), 41)
    _, (ut, unt, Pt, ttb) = _inputs(jd, x0, v, u, jnp.float64, torch.float64)
    with pytest.raises(TypeError):
        sh.stage_ho(0.0, ut.float(), unt, Pt, ttb)
    with pytest.raises(TypeError):
        sh.stage_ho(0.0, ut.to(torch.float16), unt, Pt, ttb)
    with pytest.raises(ValueError):
        sh.stage_ho(0.0, ut[:, :10], unt, Pt, ttb)
    with pytest.raises(ValueError):
        sh.stage_ho(0.0, ut, unt, Pt[:, :-1], ttb)
    with pytest.raises(ValueError, match="limiter dt"):
        sh.stage_ho(0.0, ut, unt, Pt, ttb, with_lo=True)
    with pytest.raises(ValueError, match="n_cg"):
        sh.stage_ho(0.0, ut, unt, Pt, ttb, n_cg=-1)
    tables = wd.wdet_tables(td, torch.float64, "cpu")
    xs = convert.tensor(x0)
    with pytest.raises(TypeError):
        wd.wdet(xs.float(), tables)
    with pytest.raises(ValueError):
        wd.wdet(xs[:, :-1], tables)
    with pytest.raises(ValueError):
        wd.wdet(xs[..., :1], tables)
