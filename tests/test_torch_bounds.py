"""The bounds of remhos_torch against remhos_tpu on the CPU, and kernel 1's
per-dof bounds operand.

- the bounds tables (`dofmaps.bounds_topology`: face neighbours and global
  CG nodes) equal the JAX package's;
- `sparsity_bounds`, `overlap_bounds` and `compute_bounds` (`-bt 0|1`), with
  and without `active_el`, on a 2D and a 3D mesh with mixed periodicity:
  equal to JAX's (they are minima and maxima of the same inputs);
- the plain version of the mega stage with per-dof bounds against the JAX
  Pallas kernel `fused_stage_mega_poly(..., bounds_stencil=False)` in
  interpret mode: <= 1e-12 * max|du| in f64, <= 2e-3 in f32 (the JAX f32
  kernel's bf16x3 products against true f32 products, as in
  tests/test_torch_stage.py);
- at `-bt 0` the class-major stencil expanded to dofs and fed as per-dof
  bounds gives the "T" result bit for bit;
- the operator's `-bt 1` mega stage (the per-dof variant) against the JAX
  operator's stage function: <= 1e-9 * max|du| (the JAX package's own
  Pallas-vs-XLA bar).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from remhos_tpu import bounds as jbnd
from remhos_tpu import structured as jstr
from remhos_tpu.discretization import build_discretization as jbuild
from remhos_tpu.mesh import make_cartesian_mesh as jmesh
from remhos_tpu.operator import Advection as JAdvection
from remhos_tpu.operator import SolverConfig as JConfig
from remhos_tpu.ops import pallas_kernels as pk

from remhos_torch import bounds, convert, dofmaps
from remhos_torch.discretization import build_discretization
from remhos_torch.mesh import make_cartesian_mesh
from remhos_torch.operator import Advection, SolverConfig
from remhos_torch.ops import mega_stage as ms
from torch_threads import one_torch_thread  # noqa: F401

MESHES = [((5, 4), (True, False)), ((3, 4, 2), (False, True, False))]
T_STAGE, DT = 0.3, 0.01


def _meshes(shape, periodic, p):
    dim = len(shape)
    args = (dim, shape, (0.0,) * dim, (1.0,) * dim, periodic)
    return jbuild(jmesh(*args), p), make_cartesian_mesh(*args)


def _extrema(E, seed):
    rng = np.random.default_rng(seed)
    lo = rng.standard_normal(E)
    hi = lo + rng.random(E)
    active = rng.random(E) > 0.3
    return lo, hi, active


@pytest.mark.parametrize("shape,periodic", MESHES)
@pytest.mark.parametrize("p", [1, 3])
def test_bounds_tables_equal_jax(shape, periodic, p):
    jd, mesh = _meshes(shape, periodic, p)
    topo = dofmaps.bounds_topology(mesh, p, "cpu")
    assert topo.nd == jd.nd and topo.n_cg == jd.dofmaps.n_cg
    assert np.array_equal(topo.nbr_elem.numpy(), jd.dofmaps.nbr_elem)
    assert np.array_equal(topo.cg_idx.numpy(), jd.dofmaps.cg_idx)


@pytest.mark.parametrize("shape,periodic", MESHES)
@pytest.mark.parametrize("masked", [False, True])
def test_bounds_equal_jax(shape, periodic, masked):
    jd, mesh = _meshes(shape, periodic, 2)
    dm = jd.dofmaps
    topo = dofmaps.bounds_topology(mesh, 2, "cpu")
    lo, hi, active = _extrema(mesh.num_elements, 3 + masked)
    act_j = jnp.asarray(active) if masked else None
    act_t = torch.as_tensor(active) if masked else None
    t = torch.as_tensor
    got = {
        "overlap": bounds.overlap_bounds(t(lo), t(hi), topo.cg_idx,
                                         topo.n_cg, active_el=act_t),
        "sparsity": bounds.sparsity_bounds(t(lo), t(hi), topo.nbr_elem,
                                           topo.nd),
        "bt0": bounds.compute_bounds(t(lo), t(hi), topo, 0, active_el=act_t),
        "bt1": bounds.compute_bounds(t(lo), t(hi), topo, 1, active_el=act_t)}
    want = {
        "overlap": jbnd.overlap_bounds(jnp.asarray(lo), jnp.asarray(hi),
                                       jnp.asarray(dm.cg_idx), dm.n_cg,
                                       active_el=act_j),
        "sparsity": jbnd.sparsity_bounds(jnp.asarray(lo), jnp.asarray(hi),
                                         jnp.asarray(dm.nbr_elem), dm.nd),
        "bt0": jbnd.compute_bounds(jnp.asarray(lo), jnp.asarray(hi), dm, 0,
                                   active_el=act_j),
        "bt1": jbnd.compute_bounds(jnp.asarray(lo), jnp.asarray(hi), dm, 1,
                                   active_el=act_j)}
    for k in got:
        for g, w in zip(got[k], want[k]):
            assert g.shape == tuple(w.shape), k
            assert np.array_equal(g.numpy(), np.asarray(w)), k


def _stage_inputs(shape, seed, jdt, dtype):
    """JAX and port inputs of one mega stage with per-dof sparsity bounds
    and the class-major stencil."""
    jd, mesh = _meshes(shape, (False,) * len(shape), 3)
    td = build_discretization(mesh, 3)
    rng = np.random.default_rng(seed)
    x0 = jd.mesh.x
    v = 0.1 * np.sin(x0)
    u = rng.random((mesh.num_elements, jd.nd))
    m = jd.mesh
    uj = jnp.asarray(u, jdt)
    lo_, hi_ = jbnd.elements_min_max(uj)
    xmin, xmax = jbnd.sparsity_bounds(lo_, hi_, jnp.asarray(m.nbr_elem),
                                      jd.nd)
    smin, smax = jstr.overlap_stencil_T(lo_, hi_, m.shape, m.periodic)
    unbr = jstr.gather_nbr_structured(uj, m.shape, m.periodic,
                                      jd.dofmaps.nbr_dof_local)
    unbr = unbr.reshape(m.num_elements, -1)
    tb = pk.stage_ho_tables(jd, jdt)
    P = pk.build_poly_tables(jnp.asarray(x0, jdt), jnp.asarray(v, jdt),
                             jd)["P"]
    nf, Qf = jd.n_ref.shape[0], jd.Bface.shape[0]
    ttb = convert.stage_tables(tb, convert.discretization_tables(jd), dtype)
    Pt = convert.poly(P, jd.dim, tb["Q"], nf * Qf, tb["seg"], dtype)
    c = lambda a: convert.tensor(a, dtype)
    return (jd, td, x0, v, u,
            (uj, unbr, xmin, xmax, smin, smax, P, tb),
            (c(uj), c(unbr), c(xmin), c(xmax), c(smin), c(smax), Pt, ttb))


@pytest.mark.parametrize("shape", [(4, 3, 2), (6, 4)])
@pytest.mark.parametrize("prec", ["f64", "f32"])
def test_per_dof_reference_matches_jax_kernel(shape, prec):
    jdt, dtype, tol = {"f64": (jnp.float64, torch.float64, 1e-12),
                       "f32": (jnp.float32, torch.float32, 2e-3)}[prec]
    jd, _, _, _, _, ji, ti = _stage_inputs(shape, 51, jdt, dtype)
    uj, unbr, xmin, xmax, _, _, P, tb = ji
    du_j = pk.fused_stage_mega_poly(T_STAGE, DT, uj, unbr, xmin, xmax,
                                    {"P": P}, tb, dim=jd.dim, mode=1.0,
                                    interpret=True, bounds_stencil=False)
    ut, unt, xmt, xxt, _, _, Pt, ttb = ti
    before = dict(ms.mega_stage.variant_launches)
    du_t = ms.mega_stage(T_STAGE, DT, ut, unt, xmt, xxt, Pt, ttb,
                         bounds="dof")
    assert ms.mega_stage.variant_launches == before   # CPU: plain version
    assert du_t.dtype == dtype and du_t.shape == tuple(uj.shape)
    err = float((du_t.double() - torch.as_tensor(np.array(du_j, np.float64))
                 ).abs().max())
    assert err <= tol * float(np.abs(np.asarray(du_j)).max())


@pytest.mark.parametrize("shape", [(4, 3, 2), (6, 4)])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_bt0_per_dof_equals_stencil_bit_for_bit(shape, dtype):
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    _, _, _, _, _, _, ti = _stage_inputs(shape, 61, jdt, dtype)
    ut, unt, _, _, smt, sxt, Pt, ttb = ti
    cls = ttb["cls"].long()
    du_T = ms.mega_stage(T_STAGE, DT, ut, unt, smt, sxt, Pt, ttb)
    du_dof = ms.mega_stage(T_STAGE, DT, ut, unt, smt[cls].T.contiguous(),
                           sxt[cls].T.contiguous(), Pt, ttb, bounds="dof")
    assert torch.equal(du_T, du_dof)


@pytest.mark.parametrize("shape", [(4, 3, 2), (6, 4)])
def test_bt1_mega_stage_matches_jax_operator(shape):
    """The port's -bt 1 stage (sparsity bounds, the per-dof variant) against
    the JAX operator's stage with the Pallas kernel in interpret mode."""
    jd, td, x0, v, u, _, _ = _stage_inputs(shape, 71, jnp.float64,
                                           torch.float64)
    jadv = JAdvection(jd, JConfig(problem=10, ho=3, lo=5, fct=2, pa=True,
                                  bounds_type=1),
                      jnp.asarray(x0), jnp.asarray(v), None)
    dS, _ = jadv.stage_function()(T_STAGE, DT, jnp.stack([jnp.asarray(u)]))
    adv = Advection(td, SolverConfig(bounds_type=1), x0, v,
                    dtype=torch.float64, device="cpu")
    dSt, aux = adv.stage_function()(T_STAGE, DT, convert.tensor(u)[None])
    assert aux is None                                  # the mega path
    err = float((dSt[0] - torch.as_tensor(np.array(dS[0]))).abs().max())
    assert err <= 1e-9 * float(np.abs(np.asarray(dS[0])).max())


def test_per_dof_wrapper_rejects_bad_bounds():
    _, td, x0, v, u, _, ti = _stage_inputs((4, 3, 2), 81, jnp.float64,
                                           torch.float64)
    ut, unt, xmt, xxt, smt, sxt, Pt, ttb = ti
    # "E" names the element-major stencil since PR 13: an unknown layout
    # raises, and "E" with per-dof bounds is refused by their shape
    with pytest.raises(ValueError, match="bounds"):
        ms.mega_stage(0.0, DT, ut, unt, xmt, xxt, Pt, ttb, bounds="X")
    with pytest.raises(ValueError, match="smin"):
        ms.mega_stage(0.0, DT, ut, unt, xmt, xxt, Pt, ttb, bounds="E")
    with pytest.raises(ValueError, match="smin"):
        ms.mega_stage(0.0, DT, ut, unt, smt, sxt, Pt, ttb, bounds="dof")
    with pytest.raises(ValueError, match="smin"):
        ms.mega_stage(0.0, DT, ut, unt, xmt, xxt, Pt, ttb)
