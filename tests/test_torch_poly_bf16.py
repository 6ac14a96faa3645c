"""The bf16 P16 stream of kernels 1 and 2 and kernel 1's element-major
bounds operand, the port against the JAX package on the CPU.

- the tables: `build_poly_tables(..., va_vn_bf16=True)` in f32 against the
  JAX package's: P (w_q det J, f32) to f32 round-off, P16 (va and vn,
  bf16) within one bf16 ulp of each value (a coefficient the two packages
  compute one f32 ulp apart can round to neighbouring bf16 values);
- the plain P16 stage of kernel 1 (mega) and kernel 2 (HO, with LO) against
  JAX's fused kernels with P16 in interpret mode, fed the SAME bf16 values
  (JAX's, carried by `convert.poly16`): <= 2e-3 * max|du|, the f32 bar of
  tests/test_torch_stage.py (JAX's bf16x3 products against true f32);
- an operator with poly_bf16 streams P16 in f32 and ignores it in f64, as
  remhos_tpu/operator.py:172 does;
- kernel 1's "E" plain version equals "T" on the transposed stencil bit
  for bit, and the JAX kernel with bounds_stencil=True to 1e-10 (f64).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from remhos_tpu import bounds as jbnd
from remhos_tpu import structured as jstr
from remhos_tpu.discretization import build_discretization as jbuild
from remhos_tpu.mesh import make_cartesian_mesh as jmesh
from remhos_tpu.ops import pallas_kernels as pk

from remhos_torch import convert
from remhos_torch.discretization import build_discretization
from remhos_torch.mesh import make_cartesian_mesh
from remhos_torch.operator import Advection, SolverConfig
from remhos_torch.ops import mega_stage as ms
from remhos_torch.ops import stage_ho as sh
from remhos_torch.ops import tables as tbl
from torch_threads import one_torch_thread  # noqa: F401

T_STAGE, DT = 0.3, 0.01


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


def _sizes(jd, tb):
    return jd.dim, int(tb["Q"]), jd.n_ref.shape[0] * jd.Bface.shape[0], \
        int(tb["seg"])


@pytest.mark.parametrize("shape", [(4, 3, 2), (6, 4)])
def test_tables_within_one_bf16_ulp(shape):
    jd, td, x0, v, _ = _setup(shape, 1)
    tb = pk.stage_ho_tables(jd, jnp.float32)
    j = pk.build_poly_tables(jnp.asarray(x0, jnp.float32),
                             jnp.asarray(v, jnp.float32), jd,
                             va_vn_bf16=True)
    jP, jP16 = convert.poly16(j["P"], j["P16"], *_sizes(jd, tb))
    f32 = torch.float32
    P, P16 = tbl.build_poly_tables(torch.tensor(x0, dtype=f32),
                                   torch.tensor(v, dtype=f32), td,
                                   va_vn_bf16=True)
    assert P16.dtype == torch.bfloat16 and P.dtype == f32
    assert P.shape == jP.shape and P16.shape == jP16.shape
    assert (P - jP).abs().max() <= 1e-6 * jP.abs().max()
    a, b = P16.float(), jP16.float()
    ulp = 2.0 ** -7 * torch.maximum(a.abs(), b.abs())
    assert bool(((a - b).abs() <= ulp + 1e-30).all())
    # the f32 P16 planes are the f32 P's va/vn planes rounded to bf16
    full = tbl.build_poly_tables(torch.tensor(x0, dtype=f32),
                                 torch.tensor(v, dtype=f32), td)
    lay = tbl.poly_layout(*_sizes(jd, tb)[:3])
    va_vn = torch.cat([full[:, :lay["wdet"]], full[:, lay["vn"]:]], dim=1)
    assert torch.equal(va_vn.to(torch.bfloat16), P16)
    assert torch.equal(full[:, lay["wdet"]:lay["vn"]], P)


@pytest.mark.parametrize("shape", [(4, 3, 2), (6, 4)])
def test_p16_stages_match_jax(shape):
    jd, td, x0, v, u = _setup(shape, 2)
    jdt, f32 = jnp.float32, torch.float32
    m = jd.mesh
    uj = jnp.asarray(u, jdt)
    lo_, hi_ = jbnd.elements_min_max(uj)
    smin, smax = jstr.overlap_stencil_T(lo_, hi_, m.shape, m.periodic)
    unbr = jstr.gather_nbr_structured(uj, m.shape, m.periodic,
                                      jd.dofmaps.nbr_dof_local)
    unbr = unbr.reshape(m.num_elements, -1)
    tb = pk.stage_ho_tables(jd, jdt)
    poly = pk.build_poly_tables(jnp.asarray(x0, jdt), jnp.asarray(v, jdt),
                                jd, va_vn_bf16=True)
    du_j = pk.fused_stage_mega_poly(T_STAGE, DT, uj, unbr, smin, smax, poly,
                                    tb, dim=jd.dim, mode=1.0, interpret=True,
                                    bounds_stencil="T")
    ho_j = pk.fused_stage_ho_poly(T_STAGE, uj, unbr, poly, tb, dim=jd.dim,
                                  mode=1.0, interpret=True, dt=DT,
                                  with_lo=True)
    ttb = convert.stage_tables(tb, convert.discretization_tables(jd), f32)
    P, P16 = convert.poly16(poly["P"], poly["P16"], *_sizes(jd, tb))
    c = lambda a: convert.tensor(a, f32)
    before = (ms.mega_stage.launches, sh.stage_ho.launches)
    du = ms.mega_stage(T_STAGE, DT, c(uj), c(unbr), c(smin), c(smax), P, ttb,
                       P16=P16)
    ho = sh.stage_ho(T_STAGE, c(uj), c(unbr), P, ttb, dt=DT, with_lo=True,
                     P16=P16)
    assert (ms.mega_stage.launches, sh.stage_ho.launches) == before
    for got, want in ((du, du_j), (ho[0], ho_j[0]), (ho[2], ho_j[2])):
        want = np.asarray(want, np.float64)
        err = np.abs(got.double().numpy() - want).max()
        assert err <= 2e-3 * np.abs(want).max()
    # wdet is read from the f32 P alone: f32 round-off
    w = np.asarray(ho_j[1], np.float64)
    assert np.abs(ho[1].double().numpy() - w).max() <= 1e-6 * np.abs(w).max()


def test_operator_poly_bf16_f32_only():
    shape = (3, 3, 2)
    mesh = make_cartesian_mesh(3, shape, (0,) * 3, (1,) * 3, (False,) * 3)
    disc = build_discretization(mesh, 3)
    x0 = torch.tensor(mesh.x)
    v = 0.1 * torch.sin(x0)
    cfg = SolverConfig(problem=10, poly_bf16=True)
    a32 = Advection(disc, cfg, x0, v, dtype=torch.float32, device="cpu")
    a64 = Advection(disc, cfg, x0, v, dtype=torch.float64, device="cpu")
    assert a32._poly16 is not None and a32._poly16.dtype == torch.bfloat16
    assert a64._poly16 is None
    ref = Advection(disc, SolverConfig(problem=10), x0, v,
                    dtype=torch.float64, device="cpu")
    assert torch.equal(a64._poly, ref._poly)
    u = torch.rand((mesh.num_elements, disc.nd), dtype=torch.float64)
    d64 = a64.stage_function()(0.1, DT, u[None])[0]
    dref = ref.stage_function()(0.1, DT, u[None])[0]
    assert torch.equal(d64, dref)


@pytest.mark.parametrize("shape", [(4, 3, 2), (6, 4)])
def test_element_major_variant(shape):
    jd, td, x0, v, u = _setup(shape, 3)
    m = jd.mesh
    uj = jnp.asarray(u)
    lo_, hi_ = jbnd.elements_min_max(uj)
    emin, emax = jstr.overlap_stencil_cols(lo_, hi_, m.shape, m.periodic)
    unbr = jstr.gather_nbr_structured(uj, m.shape, m.periodic,
                                      jd.dofmaps.nbr_dof_local)
    unbr = unbr.reshape(m.num_elements, -1)
    tb = pk.stage_ho_tables(jd, jnp.float64)
    P = pk.build_poly_tables(jnp.asarray(x0), jnp.asarray(v), jd)["P"]
    du_j = pk.fused_stage_mega_poly(T_STAGE, DT, uj, unbr, emin, emax,
                                    {"P": P}, tb, dim=jd.dim, mode=1.0,
                                    interpret=True, bounds_stencil=True)
    ttb = convert.stage_tables(tb, convert.discretization_tables(jd))
    nf, Qf = jd.n_ref.shape[0], jd.Bface.shape[0]
    Pt = convert.poly(P, jd.dim, tb["Q"], nf * Qf, tb["seg"])
    c = convert.tensor
    args = (T_STAGE, DT, c(uj), c(unbr))
    du_E = ms.mega_stage(*args, c(emin), c(emax), Pt, ttb, bounds="E")
    du_T = ms.mega_stage(*args, c(emin).T.contiguous(),
                         c(emax).T.contiguous(), Pt, ttb)
    assert torch.equal(du_E, du_T)
    want = np.asarray(du_j)
    assert np.abs(du_E.numpy() - want).max() <= 1e-10 * np.abs(want).max()
