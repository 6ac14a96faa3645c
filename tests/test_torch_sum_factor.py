"""The launch-path and table changes of the stage kernels and the gather,
on the CPU.

- The 1D factor tables of `ops.tables.sum_factor_tables` (what the
  sum-factorized CUDA core reads) rebuild every dense stage table by
  Kronecker products, axis 0 fastest, to 1e-13 of the table's largest entry
  in f64: dim 2 and 3, p = 1..5, mesh orders 1, 2 and 3; so do the 1D mesh
  tables of `ops.tables.mesh_factor_tables` (what kernels 3 and 4 read)
  with the dense mesh tables Bm and Gm, and a table that is not a
  Kronecker product is refused.
- `Advection.geometry(t)` of the non-fused stage issues no `aten::bmm`
  (the per-point dot products are elementwise products summed over the
  last axis), with `-lo 3` and with `-lo 4` (the subcell weights); its
  values equal the JAX package's.
- The checks made once (the stage tables when they are built, the gather's
  layout when it is first seen) leave every per-call refusal in place: after
  a good call, the bad operands of the existing refusal tests are still
  refused with the same errors.
- The gather's layout cache is keyed right: a second layout after the first
  gives the second layout's answer, an in-place change of a tensor table is
  seen, and the first layout's answer comes back.
"""

import dataclasses

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import jax.numpy as jnp

from remhos_tpu.discretization import build_discretization as jbuild
from remhos_tpu.mesh import make_cartesian_mesh as jmesh
from remhos_tpu.operator import Advection as JAdvection
from remhos_tpu.operator import SolverConfig as JConfig

from remhos_torch import geometry as geo
from remhos_torch.discretization import build_discretization
from remhos_torch.dofmaps import build_dofmaps
from remhos_torch.mesh import make_cartesian_mesh
from remhos_torch.operator import Advection, SolverConfig
from remhos_torch.ops import gather_nbr as gn
from remhos_torch.ops import mega_stage as ms
from remhos_torch.ops import stage_ho as sh
from remhos_torch.ops import stage_ho_nodes as shn
from remhos_torch.ops import tables as tbl
from torch_threads import one_torch_thread  # noqa: F401

REL = 1e-13


def _disc(shape, p, mesh_order=2):
    dim = len(shape)
    return build_discretization(make_cartesian_mesh(
        dim, shape, (0.0,) * dim, (1.0,) * dim, (False,) * dim, mesh_order),
        p)


def _kron(factors):
    """The dense table of per-axis factors [axis 0, axis 1, ...]: axis 0
    fastest in both the row and the column index."""
    out = factors[-1]
    for f in reversed(factors[:-1]):
        out = np.kron(out, f)
    return out


def _close(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= REL * np.abs(want).max()


@pytest.mark.parametrize("mesh_order", [1, 2, 3])
@pytest.mark.parametrize("p", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("shape", [(2, 2, 2), (3, 2)], ids=str)
def test_factor_tables_rebuild_the_dense_tables(shape, p, mesh_order):
    disc = _disc(shape, p, mesh_order)
    dim = len(shape)
    tb = tbl.stage_ho_tables(disc, torch.float64, "cpu")
    f = tbl.sum_factor_tables(disc)
    assert (tb["D"], tb["Q1"]) == (f["D"], f["Q1"]) == (p + 1, f["Q1"])
    B1, G1 = f["B1"], f["G1"]
    _close(_kron([B1] * dim), tb["Bu"])
    _close(_kron([f["Bw1"]] * dim), tb["Buw"])
    Q = tb["Q"]
    for b in range(dim):
        Gb = _kron([G1 if a == b else B1 for a in range(dim)])
        _close(Gb.T, tb["GuT"][:, b * Q:(b + 1) * Q])
    A = _kron([f["A1"]] * dim)
    _close(A, tb["A"])
    _close(A.T, tb["AT"])
    _close(_kron([f["Bgl1"]] * dim), tb["Bgl"])
    _close(_kron([f["Bgl1"]] * dim).T, tb["BglT"])
    _close(_kron([f["Bgl21"]] * dim), tb["Bgl2"])
    _close(_kron([f["Bf1"]] * (dim - 1)), tb["Bface"])
    _close(_kron([f["wBf1"]] * (dim - 1)), tb["SBf"])
    # the packed block the kernels stage, in SF_TABLES order
    packed = np.concatenate([f[k].ravel() for k in tbl.SF_TABLES])
    _close(tb["sf"], packed)
    assert tb["checked"] == (torch.float64, torch.device("cpu"))
    # the mesh tables of kernels 3 and 4
    m = tbl.mesh_factor_tables(disc)
    assert (m["m1"], m["Q1"]) == (mesh_order + 1, f["Q1"])
    Bm1, Gm1 = m["Bm1"], m["Gm1"]
    _close(_kron([Bm1] * dim), disc.Bm)
    for b in range(dim):
        _close(_kron([Gm1 if a == b else Bm1 for a in range(dim)]),
               disc.Gm[:, :, b])
    block = tbl.mesh_factor_block(disc, torch.float64, "cpu")
    _close(block["msf"], np.concatenate([Bm1.ravel(), Gm1.ravel()]))


@pytest.mark.parametrize("p", [1, 3, 5])
@pytest.mark.parametrize("mesh_order", [1, 2, 3])
@pytest.mark.parametrize("shape", [(2, 2, 2), (3, 2)], ids=str)
def test_face_descriptors_rebuild_the_dense_face_tables(shape, mesh_order, p):
    """Kernel 5's face descriptors with the 1D mesh tables rebuild the
    plain version's dense face tables: per face the Kronecker product of the
    one-hot row of the face's node along the normal axis, Gm1 along the
    tangent's axis and Bm1 along the other in-face axis (axis 0 fastest):
    the first tangent with the reference-normal sign, the second (3D) and
    Bmf, to 1e-13 in f64. The conventions of geometry.face_tangent_tables:
    tangent axes (k+1)%3, (k+2)%3 (2D: 1 - k), the sign of n_ref, times -1
    in 2D where k != 0."""
    disc = _disc(shape, p, mesh_order)
    dim = len(shape)
    tb = shn.stage_ho_nodes_tables(disc, torch.float64, "cpu")
    fdesc = tb["fdesc"]
    assert fdesc.dtype == torch.int32 and tuple(fdesc.shape) == (2 * dim, 5)
    m = tbl.mesh_factor_tables(disc)
    m1, Bm1, Gm1 = m["m1"], m["Bm1"], m["Gm1"]
    assert m1 == mesh_order + 1
    Gt, sgn = geo.face_tangent_tables(disc.Gmf, disc.n_ref)
    for f, (k, side, t1, t2, sign) in enumerate(fdesc.tolist()):
        n_ref = np.zeros(dim)
        n_ref[k] = 1.0 if side else -1.0
        assert np.array_equal(disc.n_ref[f], n_ref)
        end = np.zeros((1, m1))
        end[0, m1 - 1 if side else 0] = 1.0

        def dense(deriv):
            return _kron([end if a == k else (Gm1 if a == deriv else Bm1)
                          for a in range(dim)])

        if dim == 3:
            assert (t1, t2) == ((k + 1) % 3, (k + 2) % 3)
            assert sign == n_ref[k]
            _close(dense(t2), Gt[f, ..., 1])
        else:
            assert (t1, t2) == (1 - k, -1)
            assert sign == n_ref[k] * (1 if k == 0 else -1)
        _close(sign * dense(t1), Gt[f, ..., 0] * sgn[f])
        _close(dense(-1), disc.Bmf[f])
    # the kernel's packed 1D mesh tables
    _close(tb["msf"], np.concatenate([Bm1.ravel(), Gm1.ravel()]))


def test_mesh_factor_tables_refuse_a_non_kronecker_table():
    disc = _disc((2, 2, 2), 2)
    Gm = disc.Gm.copy()
    Gm[3, 5, 1] += 1e-6
    with pytest.raises(ValueError, match="Kronecker"):
        tbl.mesh_factor_tables(dataclasses.replace(disc, Gm=Gm))
    with pytest.raises(ValueError, match="tensor-product"):
        tbl.mesh_factor_tables(dataclasses.replace(disc, Bm=disc.Bm[:, :-1]))


def _nonfused(shape, lo, ho):
    dim = len(shape)
    args = (dim, shape, (0.0,) * dim, (1.0,) * dim, (False,) * dim)
    jd, td = jbuild(jmesh(*args), 3), build_discretization(
        make_cartesian_mesh(*args), 3)
    x0 = jd.mesh.x
    v = 0.1 * np.sin(3.0 * x0) * np.cos(2.0 * x0[..., ::-1])
    kw = dict(problem=10, fct=2, pa=True, ho=ho, lo=lo)
    jadv = JAdvection(jd, JConfig(use_pallas=True, **kw), jnp.asarray(x0),
                      jnp.asarray(v), None)
    adv = Advection(td, SolverConfig(**kw), x0, v, dtype=torch.float64,
                    device="cpu")
    return jadv, adv


@pytest.mark.parametrize("lo,ho", [(3, 3), (4, 2)])
def test_nonfused_geometry_issues_no_bmm(lo, ho):
    jadv, adv = _nonfused((4, 3, 2), lo, ho)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        geom = adv.geometry(0.3)
    names = {e.key for e in prof.key_averages()}
    assert "aten::bmm" not in names
    jgeom = jadv.geometry(0.3)
    keys = ["wvn"] + (["sub_w"] if lo == 4 else [])
    for k in keys:
        want = np.asarray(jgeom[k])
        got = geom[k].numpy().reshape(want.shape)
        assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()


def _stage_setup():
    disc = _disc((3, 2, 2), 3)
    x0 = disc.mesh.x
    v = 0.1 * np.sin(3.0 * x0) * np.cos(2.0 * x0[..., ::-1])
    adv = Advection(disc, SolverConfig(), x0, v, dtype=torch.float64,
                    device="cpu")
    rng = np.random.default_rng(5)
    u = torch.as_tensor(rng.random((x0.shape[0], disc.nd)))
    unbr = adv.gather_nbr(u).reshape(u.shape[0], -1)
    s = torch.zeros(27, u.shape[0], dtype=torch.float64)
    return adv, u, unbr, s


def test_stage_wrappers_refuse_after_a_good_call():
    adv, u, unbr, s = _stage_setup()
    P, tb = adv._poly, adv._stage_tables
    ms.mega_stage(0.0, 0.01, u, unbr, s, s, P, tb)          # a good call
    sh.stage_ho(0.0, u, unbr, P, tb)
    assert "checked" in tb
    bad = [((u.float(), unbr, s, s, P), TypeError),
           ((u.to(torch.float16), unbr, s, s, P), TypeError),
           ((u[:, :10], unbr, s, s, P), ValueError),
           ((u, unbr[:, :10], s, s, P), ValueError),
           ((u, unbr, s[:9], s, P), ValueError),
           ((u, unbr, s, s, P[:, :-1]), ValueError)]
    for args, err in bad:
        with pytest.raises(err):
            ms.mega_stage(0.0, 0.01, *args[:4], args[4], tb)
    for args, err in bad[:3] + bad[5:]:
        with pytest.raises(err):
            sh.stage_ho(0.0, args[0], args[1], args[4], tb)
    with pytest.raises(ValueError, match="limiter dt"):
        sh.stage_ho(0.0, u, unbr, P, tb, with_lo=True)
    with pytest.raises(ValueError, match="n_cg"):
        sh.stage_ho(0.0, u, unbr, P, tb, n_cg=-1)


def test_stage_ho_nodes_refuses_after_a_good_call():
    adv, u, unbr, _ = _stage_setup()
    tb = shn.stage_ho_nodes_tables(adv.disc, torch.float64, "cpu")
    xs = adv.x0_nodes + 0.3 * adv.v_nodes
    v = adv.v_nodes
    shn.stage_ho_nodes(xs, v, u, unbr, tb, mode=1)
    assert shn.CHECKED in tb
    with pytest.raises(ValueError, match="mode"):
        shn.stage_ho_nodes(xs, v, u, unbr, tb, mode=0.5)
    with pytest.raises(TypeError, match="must be torch.float64"):
        shn.stage_ho_nodes(xs, v.float(), u, unbr, tb, mode=1)
    with pytest.raises(ValueError, match="u_nbr must be"):
        shn.stage_ho_nodes(xs, v, u, unbr[:, :-1], tb, mode=1)
    with pytest.raises(ValueError, match="xs must be"):
        shn.stage_ho_nodes(xs[..., :1], v, u, unbr, tb, mode=1)


def test_tables_are_checked_once_where_built():
    adv, *_ = _stage_setup()
    tb = tbl.stage_ho_tables(adv.disc, torch.float64, "cpu")
    assert tb["checked"] == (torch.float64, torch.device("cpu"))
    bad = dict(tb, Bu=tb["Bu"].float())
    del bad["checked"]
    with pytest.raises(TypeError, match="Bu is torch.float32"):
        tbl.check_tables(bad)
    bad = dict(tb, bdr=tb["bdr"][:, :-1])
    with pytest.raises(ValueError, match="bdr must be"):
        tbl.check_tables(bad)


def _gather_inputs(shape, p=2, seed=0):
    dm = build_dofmaps(len(shape), p)
    rng = np.random.default_rng(seed)
    u = torch.as_tensor(rng.standard_normal((int(np.prod(shape)), dm.nd)))
    return u, dm.nbr_dof_local


def test_gather_nbr_refuses_after_a_good_call():
    u, nbr = _gather_inputs((8, 5))
    lay = gn.GatherLayout((8, 5), (True, True), nbr, "cpu")
    gn.gather_nbr(u, lay)                       # a layout already used
    with pytest.raises(ValueError, match="u must be"):
        gn.gather_nbr(u[:-1], lay)
    with pytest.raises(ValueError, match="u must be"):
        gn.gather_nbr(u[:, :3], lay)
    with pytest.raises(ValueError, match="nbr_dof_local must be"):
        gn.GatherLayout((8, 5), (True, True), nbr[:3], "cpu")
    with pytest.raises(ValueError, match="u must be"):
        gn.gather_nbr(u.reshape(-1), lay)


@pytest.mark.parametrize("table", ["array", "tensor"])
def test_gather_nbr_layout_cache_key(table):
    """Layouts used in turn each give their own answer; a layout keeps its
    own copy of the table."""
    shapes = [((4, 3, 2), (False, False, False)),
              ((2, 3, 4), (True, True, True)),
              ((4, 3, 2), (True, False, True))]
    _, nbr = _gather_inputs((4, 3, 2))
    if table == "tensor":
        nbr = torch.as_tensor(nbr, dtype=torch.int32)
    lays = [gn.GatherLayout(shape, periodic, nbr, "cpu")
            for shape, periodic in shapes]
    rng = np.random.default_rng(1)
    for lay, (shape, periodic) in zip(lays + lays[:1], shapes + shapes[:1]):
        u = torch.as_tensor(rng.standard_normal((24, 27)))
        want = gn.gather_nbr_reference(u, shape, periodic,
                                       torch.as_tensor(nbr))
        assert torch.equal(gn.gather_nbr(u, lay), want)
    if table == "tensor":
        u = torch.as_tensor(rng.standard_normal((24, 27)))
        old = gn.gather_nbr_reference(u, *shapes[0], nbr.clone())
        nbr.copy_(nbr.flip(1))
        assert torch.equal(gn.gather_nbr(u, lays[0]), old)
        new = gn.GatherLayout(*shapes[0], nbr, "cpu")
        assert torch.equal(gn.gather_nbr(u, new),
                           gn.gather_nbr_reference(u, *shapes[0], nbr))
