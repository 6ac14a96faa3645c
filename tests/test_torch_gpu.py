"""remhos_torch on the card: the CUDA kernels against their plain versions
and short runs of the main path and of driver.run's paths with their launch
counts. Every test here is marked `gpu` and skips where
torch.cuda.is_available() is false.

This file imports neither jax nor remhos_tpu, so it also runs on a machine
without them:  python -m pytest tests/test_torch_gpu.py -m gpu --noconftest
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from remhos_torch import bench, bounds, driver, geometry, structured
from remhos_torch import problems as prob
from remhos_torch.config import RunConfig
from remhos_torch.discretization import build_discretization
from remhos_torch.mesh import make_cartesian_mesh
from remhos_torch.operator import Advection, SolverConfig
from remhos_torch import ops
from remhos_torch.ops import fa_assemble as fa
from remhos_torch.ops import gather_nbr as gn
from remhos_torch.ops import geom_conv as gc
from remhos_torch.ops import gl_cg as cg
from remhos_torch.ops import mega_stage as ms
from remhos_torch.ops import stage_core as core
from remhos_torch.ops import stage_ho as sh
from remhos_torch.ops import stage_ho_nodes as shn
from remhos_torch.ops import wdet as wd
from remhos_torch.utils import trace as trc

DT = 0.2 / 320


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.gpu
@pytest.mark.parametrize("dim,n", [(3, 5), (2, 9)])
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-10),
                                       (torch.float32, 2e-4)])
def test_kernel_matches_reference(dim, n, dtype, tol):
    """Kernel vs plain version, one stage, random u from a seed. Tolerances
    relative to max|du| as in chip_smoke.py: f64 round-off; f32 10x above
    the kernel's FMA ordering differences (~2e-5), below the ~2.5e-3 that a
    lost Jacobi sweep would make."""
    _cuda()
    case = bench.build_case(n=n, order=3, dtype=dtype, device="cuda",
                            n_steps=4, dt=DT, dim=dim)
    adv = case.adv
    rng = np.random.default_rng(7)
    u = torch.as_tensor(rng.random(tuple(case.u0.shape)), dtype=dtype,
                        device="cuda")
    unbr = adv.gather_nbr(u).reshape(u.shape[0], -1)
    smin, smax = structured.overlap_stencil_T(
        *bounds.elements_min_max(u), adv.shape, adv.periodic, adv.masks)
    args = (0.1, DT, u, unbr, smin, smax, adv._poly, adv._stage_tables)
    before = ms.mega_stage.launches
    got = ms.mega_stage(*args)
    torch.cuda.synchronize()
    assert ms.mega_stage.launches == before + 1
    ref = ms.mega_stage_reference(*args, ms.default_sweeps(dtype))
    err = (got - ref).abs().max().item()
    assert err <= tol * ref.abs().max().item()


@pytest.mark.gpu
def test_short_main_path():
    """8 verified RK3 steps through the kernel: 3 launches a step plus the
    cross check's 2 f32 and 2 f64 steps."""
    _cuda()
    case = bench.build_case(n=6, order=3, dtype=torch.float32,
                            device="cuda", n_steps=8, dt=DT)
    before = ms.mega_stage.launches
    rec = bench.run(case)
    assert ms.mega_stage.launches - before == 3 * 8 + 12
    assert rec["verified"] and rec["cross_check"]["status"] == "ran"


@pytest.mark.gpu
def test_bench_record_on_the_card():
    """bench.main at 6^3: best of 2 windows after a warm-up, verified, the
    kernel launched 3 times a step in each timed window, the card named."""
    _cuda()
    rec = bench.main(env=dict(BENCH_N="6", BENCH_STEPS="8", BENCH_REPS="2",
                              BENCH_DT=str(DT), BENCH_PHASES="0",
                              BENCH_TRACE="0"))
    assert rec["verified"] is True and rec["windows"] == 2
    assert rec["kernels"]["mega_stage"] == 3 * 8 * 2
    assert rec["device"] != "cpu" and rec["hbm_util_model"] > 0


@pytest.mark.gpu
def test_transport_runs_no_kernel():
    """Transport on the card: the JAX package's routing, no kernel."""
    _cuda()
    ops.reset_launch_counts()
    res = driver.run(RunConfig(mesh="periodic-cube", rs_levels=1, order=3,
                               problem=0, ho=3, lo=5, fct=2, pa=True,
                               dtype="float32", dt=0.0025, t_final=0.01,
                               verbose=False, device="cuda"))
    assert res.steps == 4 and set(ops.launch_counts().values()) == {0}
    assert res.mass_loss_u <= 1e-6 * res.final_mass_u


@pytest.mark.gpu
@pytest.mark.parametrize("dim,n", [(3, 5), (2, 9)])
@pytest.mark.parametrize("dtype,tol,wtol", [(torch.float64, 1e-10, 1e-12),
                                            (torch.float32, 2e-4, 1e-5)])
@pytest.mark.parametrize("with_lo,n_cg", [(True, None), (False, None),
                                          (True, 0)])
def test_stage_ho_matches_reference(dim, n, dtype, tol, wtol, with_lo, n_cg):
    """The HO stage kernel vs its plain version: du_HO, wdet and du_LO.
    n = 5 (125 elements) and n = 9 (81) leave a ragged last tile for every
    tile size (8, 4, 32, 16 elements). Tolerances as in chip_smoke.py,
    relative to the largest entry of the plain result."""
    _cuda()
    case = bench.build_case(n=n, order=3, dtype=dtype, device="cuda",
                            n_steps=4, dt=DT, dim=dim)
    adv = case.adv
    rng = np.random.default_rng(8)
    u = torch.as_tensor(rng.random(tuple(case.u0.shape)), dtype=dtype,
                        device="cuda")
    unbr = adv.gather_nbr(u).reshape(u.shape[0], -1)
    before = sh.stage_ho.launches
    got = sh.stage_ho(0.1, u, unbr, adv._poly, adv._stage_tables, n_cg=n_cg,
                      dt=DT, with_lo=with_lo)
    torch.cuda.synchronize()
    assert sh.stage_ho.launches == before + 1
    ref = sh.stage_ho_poly_reference(
        0.1, u, unbr, adv._poly, adv._stage_tables,
        sh.default_sweeps(dtype) if n_cg is None else n_cg, dt=DT,
        with_lo=with_lo)
    assert len(got) == len(ref) == (3 if with_lo else 2)
    for g, r, lim in zip(got, ref, (tol, wtol, tol)):
        assert (g - r).abs().max().item() <= lim * r.abs().max().item()


GOLDENS = Path(__file__).resolve().parents[1] / "goldens" / \
    "reference_goldens.json"


def _golden_row(name):
    return next(r for r in json.loads(GOLDENS.read_text())["runs"]
                if r["name"] == name)


def _nonfused_operator(shape, dtype):
    """A non-fused operator on the card: p=3 on an n^dim box with the
    benchmark's mesh motion; (dim, n, p, mesh order): order p on an n^dim
    box of that mesh order with a smooth mesh velocity; or the operator of a
    named golden row (the `remap-cube3d-*pa` rows: their own mesh, p=2)."""
    if isinstance(shape, tuple) and len(shape) == 4:
        dim, n, p, mesh_order = shape
        mesh = make_cartesian_mesh(dim, (n,) * dim, (0.0,) * dim,
                                   (1.0,) * dim, (False,) * dim, mesh_order)
        x0 = mesh.x
        v = 0.1 * np.sin(3.0 * x0) * np.cos(2.0 * x0[..., ::-1])
        return Advection(build_discretization(mesh, p),
                         SolverConfig(problem=10, ho=3, lo=3, fct=2, pa=True),
                         x0, v, dtype=dtype, device="cuda")
    if isinstance(shape, str):
        name = "float32" if dtype == torch.float32 else "float64"
        return driver.build_operator(RunConfig(
            verbose=False, device="cuda", dtype=name,
            **_golden_row(shape)["cfg"]))[0]
    dim, n = shape
    base = bench.build_case(n=n, order=3, dtype=dtype, device="cuda",
                            n_steps=4, dt=DT, dim=dim).adv
    return Advection(base.disc, SolverConfig(problem=10, ho=3, lo=3, fct=2,
                                             pa=True), base.x0_nodes,
                     base.v_nodes, dtype=dtype, device="cuda")


# (dim, n) at p=3, a golden row, then (dim, n, p, mesh order): p = 1 and 5
# and mesh orders 1 and 3 run the kernels' runtime sizes
SHAPES = [(3, 5), (2, 9), "remap-cube3d-m3pa",
          (3, 5, 1, 2), (3, 4, 5, 2), (3, 4, 3, 1), (3, 4, 3, 3),
          (2, 9, 1, 2), (2, 9, 5, 2), (2, 8, 3, 1), (2, 8, 3, 3)]


@pytest.mark.gpu
@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12),
                                       (torch.float32, 1e-5)])
def test_wdet_matches_reference(shape, dtype, tol):
    """The wdet kernel vs its plain version on moved nodes; 125, 81 and 64
    elements leave a ragged last tile, the golden row's mesh gives it p=2,
    and the 4-tuples other orders and mesh orders (runtime sizes)."""
    _cuda()
    adv = _nonfused_operator(shape, dtype)
    xs = (adv.x0_nodes + 0.3 * adv.v_nodes).contiguous()
    before = wd.wdet.launches
    got = wd.wdet(xs, adv._wdet_tables)
    torch.cuda.synchronize()
    assert wd.wdet.launches == before + 1
    ref = wd.wdet_reference(xs, adv._wdet_tables)
    assert (got - ref).abs().max().item() <= tol * ref.abs().max().item()


@pytest.mark.gpu
@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12),
                                       (torch.float32, 1e-5)])
def test_wdet_face_matches_reference(shape, dtype, tol):
    """The wdet kernel's face variant on the shapes of
    test_wdet_matches_reference: wvn against its plain version on moved
    nodes with the mesh velocity, wdet bit for bit the wdet-only variant's,
    one launch counted under "face"."""
    _cuda()
    adv = _nonfused_operator(shape, dtype)
    xs = (adv.x0_nodes + 0.3 * adv.v_nodes).contiguous()
    tb = adv._wdet_tables
    before = (wd.wdet.launches, dict(wd.wdet.variant_launches))
    wdet, wvn = wd.wdet(xs, tb, adv.v_nodes)
    torch.cuda.synchronize()
    assert wd.wdet.launches == before[0] + 1
    assert wd.wdet.variant_launches == dict(before[1],
                                            face=before[1]["face"] + 1)
    _, ref = wd.wdet_reference(xs, tb, adv.v_nodes)
    assert wvn.shape == ref.shape and ref.max().item() > 0
    assert (wvn - ref).abs().max().item() <= tol * ref.abs().max().item()
    assert torch.equal(wdet, wd.wdet(xs, tb))


@pytest.mark.gpu
@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("dtype,tol,wtol", [(torch.float64, 1e-12, 1e-12),
                                            (torch.float32, 1e-5, 1e-5)])
@pytest.mark.parametrize("sign", [1.0, -1.0])
@pytest.mark.parametrize("with_wdet", [True, False])
def test_geom_conv_matches_reference(shape, dtype, tol, wtol, sign,
                                     with_wdet):
    """The geom_conv kernel vs its plain version on moved nodes, the mesh
    velocity and a random u: Ku and (with_wdet) wdet, else None; ragged last
    tiles, the golden row's p=2 and the runtime sizes as in
    test_wdet_matches_reference. Tolerances as in chip_smoke.py."""
    _cuda()
    adv = _nonfused_operator(shape, dtype)
    xs = adv.x0_nodes + 0.3 * adv.v_nodes
    rng = np.random.default_rng(9)
    u = torch.as_tensor(rng.random((xs.shape[0], adv.disc.nd)), dtype=dtype,
                        device="cuda")
    before = gc.geom_conv.launches
    got = gc.geom_conv(xs, adv.v_nodes, u, adv._gc_tables, sign, with_wdet)
    torch.cuda.synchronize()
    assert gc.geom_conv.launches == before + 1
    ref = gc.geom_conv_reference(xs, adv.v_nodes, u, adv._gc_tables, sign)
    assert (got[1] is None) == (not with_wdet)
    for g, r, lim in list(zip(got, ref, (tol, wtol)))[:1 + with_wdet]:
        assert (g - r).abs().max().item() <= lim * r.abs().max().item()
    with pytest.raises(ValueError, match="contiguous"):
        gc.geom_conv(xs, adv.v_nodes, u.T.contiguous().T, adv._gc_tables,
                     sign)


def _counts():
    return ms.mega_stage.launches, sh.stage_ho.launches, wd.wdet.launches


PATH = dict(mesh="default", dim=3, elem_per_shard=6 ** 3, order=3,
            problem=10, ho=3, lo=5, fct=2, pa=True, product_sync=True,
            t_final=0.7, dt=DT, verbose=False, device="cuda")


@pytest.mark.gpu
def test_short_path_a():
    """Product remap through driver.run in f32 with the closure: two HO
    stage launches per stage, two wdet launches per run, no mega stage."""
    _cuda()
    m0, h0, w0 = _counts()
    f0 = wd.wdet.variant_launches["face"]
    r = driver.run(RunConfig(ode_solver=3, dtype="float32", max_tsteps=8,
                             **PATH))
    m1, h1, w1 = _counts()
    assert (m1 - m0, h1 - h0, w1 - w0) == (0, 2 * 3 * r.steps_total, 2)
    assert wd.wdet.variant_launches["face"] == f0   # the fused stage
    assert r.steps == 8 and r.mass_closure_injected_rel < 1e-5
    assert r.mass_loss_u < 1e-6 * r.final_mass_u
    assert r.mass_loss_us < 1e-5 * r.final_mass_us


@pytest.mark.gpu
def test_short_path_a_dt_control():
    """The same in f64 with dt control from a dt that is too large: the
    first attempts roll back (7 of them on the CPU), then steps are
    accepted; every attempt launches the HO stage. max_tsteps must exceed
    the rollbacks: the step count is compared only after an accepted step,
    as in the reference, and a run that rolls back past it goes on to the
    end of the pseudo-time."""
    _cuda()
    m0, h0, w0 = _counts()
    r = driver.run(RunConfig(ode_solver=3, dtype="float64", dt_control=1,
                             max_tsteps=30,
                             **dict(PATH, dt=5e-4, t_final=0.1)))
    m1, h1, w1 = _counts()
    assert (m1 - m0, h1 - h0, w1 - w0) == (0, 2 * 3 * r.steps_total, 2)
    assert r.steps_total == 30 > r.steps >= 15 and r.dt < 5e-4


@pytest.mark.gpu
def test_short_path_b():
    """IDP-RK3 product remap with -vb in f64: clean at the reference's
    1e-12, the HO stage without its LO output. On 8^3 elements: with
    -lo 5 the LO check of -vb fires on under-resolved data, and the 6^3
    mesh of the other tests trips it in the first step."""
    _cuda()
    m0, h0, w0 = _counts()
    r = driver.run(RunConfig(ode_solver=13, dtype="float64",
                             verify_bounds=True, max_tsteps=6,
                             **dict(PATH, elem_per_shard=8 ** 3)))
    m1, h1, w1 = _counts()
    assert (m1 - m0, h1 - h0, w1 - w0) == (0, 2 * 3 * 6, 2)
    assert r.max_s <= 3.0 + 1e-8
    assert r.mass_loss_us < 1e-8 * r.final_mass_us


@pytest.mark.gpu
def test_short_path_c():
    """Product remap with the residual-distribution LO solution (-lo 3)
    through driver.run in f32 with the closure: the non-fused stage, per
    stage one wdet launch (its face variant, as for the two mass reports)
    and three geom_conv launches and two CG solves."""
    _cuda()
    m0, h0, w0 = _counts()
    g0 = gc.geom_conv.launches
    f0 = wd.wdet.variant_launches["face"]
    r = driver.run(RunConfig(ode_solver=3, dtype="float32", max_tsteps=8,
                             **dict(PATH, lo=3)))
    m1, h1, w1 = _counts()
    assert (m1 - m0, h1 - h0, w1 - w0) == (0, 0, 3 * 8 + 2)
    assert wd.wdet.variant_launches["face"] - f0 == 3 * 8 + 2
    assert gc.geom_conv.launches - g0 == 9 * 8
    assert r.steps == 8 and r.cg_solves == 6 * 8
    assert r.mass_closure_injected_rel < 1e-5
    assert r.mass_loss_u < 1e-6 * r.final_mass_u
    assert r.mass_loss_us < 1e-5 * r.final_mass_us


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["remap-pacman-m3pa", "remap-pacman-m4pa"])
def test_pacman_golden_rows(name):
    """The two 667-step remap -pa golden rows of the non-fused path
    (-ho 2 -lo 3|4 -fct 2) in f64 on the card, at tools/run_goldens.py's
    tolerance."""
    _cuda()
    row = _golden_row(name)
    g0 = gc.geom_conv.launches
    r = driver.run(RunConfig(verbose=False, device="cuda", **row["cfg"]))
    assert gc.geom_conv.launches - g0 == 6 * r.steps_total
    for got, want in ((r.final_mass_u, row["mass"]), (r.max_u, row["max"])):
        assert abs(got - want) <= 5e-10 * max(abs(got), abs(want))


_OPERATORS = {}


def _nodes_operator(dim, n, p, mesh_order, dtype):
    """An operator of order p on the n^dim box (mesh order 2: the
    benchmark's; 1 and 3: `_nonfused_operator`'s, with its smooth mesh
    velocity) and its nodes x0 + 0.3 v, made once per test process."""
    key = (dim, n, p, mesh_order, dtype)
    if key not in _OPERATORS:
        if mesh_order == 2:
            adv = bench.build_case(n=n, order=p, dtype=dtype, device="cuda",
                                   n_steps=4, dt=DT, dim=dim).adv
        else:
            adv = _nonfused_operator((dim, n, p, mesh_order), dtype)
        xs = (adv.x0_nodes + 0.3 * adv.v_nodes).contiguous()
        tb = shn.stage_ho_nodes_tables(adv.disc, dtype, "cuda")
        tb64 = shn.stage_ho_nodes_tables(adv.disc, torch.float64, "cuda")
        _OPERATORS[key] = (adv, xs, tb, tb64)
    return _OPERATORS[key]


# kernel 5's options beside its defaults
NODES_OPTS = [{}, dict(n_cg=0), dict(with_face=False), dict(mode=-1.0)]


def _extended_du(adv, xs, u, mode, n_cg):
    """Kernel 5's du without the face flux (3D), evaluated in numpy
    longdouble (a 64-bit mantissa on x86) on the CPU from the dense tables:
    J, the cofactors and v_q at the volume points, Ku, then b = Ku A, the
    Jacobi diagonal, n_cg sweeps and x A^T."""
    L = np.longdouble
    d = adv.disc
    X, V, U = (np.asarray(t.double().cpu().numpy(), L)
               for t in (xs, adv.v_nodes, u))
    Gm, Bm, Gu, Bu, wq, A, Bgl = (np.asarray(a, L) for a in (
        d.Gm, d.Bm, d.Gu, d.Bu, d.w_q, d.A_gl2b, d.Bgl))
    J = np.einsum("end,qnb->eqdb", X, Gm)
    vq = np.einsum("end,qn->eqd", V, Bm)

    def cof(i, b):
        i1, i2, b1, b2 = (i + 1) % 3, (i + 2) % 3, (b + 1) % 3, (b + 2) % 3
        return (J[..., i1, b1] * J[..., i2, b2]
                - J[..., i1, b2] * J[..., i2, b1])

    det = sum(J[..., 0, b] * cof(0, b) for b in range(3))
    grad = np.einsum("ej,qjb->eqb", U, Gu)
    duq = sum(sum(cof(i, b) * vq[..., i] for i in range(3)) * grad[..., b]
              for b in range(3))
    w = wq * det
    b_ = ((mode * duq * wq) @ Bu) @ A
    inv = 1 / (w @ (Bgl * Bgl))
    x = inv * b_
    for _ in range(n_cg):
        x = x + inv * (b_ - ((x @ Bgl.T) * w) @ Bgl)
    return x @ A.T


def _stage_ho_nodes_case(adv, xs, tb, tb64, seed, opts, tol, plain_f32,
                         extended=False):
    """Kernel 5 vs its plain version with options `opts` on operator adv:
    du (Ku with n_cg=0) in f64 against the plain version at `tol` of
    max|du| (`extended`: against `_extended_du` instead, at `tol` or, where
    the f64 plain result lies farther from it, no farther); in f32 against
    the plain version evaluated in f64, at `tol` or, with `plain_f32`, no
    farther than the f32 plain version lies. wdet in the working type at
    the wdet limits."""
    dtype = xs.dtype
    rng = np.random.default_rng(seed)
    u = torch.as_tensor(rng.standard_normal((xs.shape[0], adv.disc.nd)),
                        dtype=dtype, device="cuda")
    unbr = adv.gather_nbr(u).reshape(u.shape[0], -1)
    kw = dict(dict(mode=1.0), **opts)
    before = shn.stage_ho_nodes.launches
    got = shn.stage_ho_nodes(xs, adv.v_nodes, u, unbr, tb, **kw)
    torch.cuda.synchronize()
    assert shn.stage_ho_nodes.launches == before + 1
    n_cg = kw.pop("n_cg", sh.default_sweeps(dtype))
    ref = shn.stage_ho_nodes_reference(xs, adv.v_nodes, u, unbr, tb,
                                       n_cg=n_cg, **kw)
    wtol = 1e-5 if dtype == torch.float32 else 1e-12
    if dtype == torch.float32:
        ref64 = shn.stage_ho_nodes_reference(
            *_f64(xs, adv.v_nodes, u, unbr), tb64, n_cg=n_cg, **kw)[0]
        if plain_f32:
            tol = ((ref[0].double() - ref64).abs().max().item()
                   / ref64.abs().max().item())
        ref = (ref64, ref[1])
        got = (got[0].double(), got[1])
    elif extended:
        ext = _extended_du(adv, xs, u, kw["mode"], n_cg)

        def dist(x):
            x = np.asarray(x.cpu().numpy(), np.longdouble)
            return float(np.abs(x - ext).max() / np.abs(ext).max())

        assert dist(got[0]) <= max(tol, dist(ref[0]))
        got, ref = got[1:], ref[1:]
        tol, wtol = wtol, None
    for g, r, lim in zip(got, ref, (tol, wtol)):
        assert (g - r).abs().max().item() <= lim * r.abs().max().item()


@pytest.mark.gpu
@pytest.mark.parametrize("dim,n", [(3, 8), (2, 9), (3, 12)])
@pytest.mark.parametrize("mesh_order", [2, 1, 3])
@pytest.mark.parametrize("seed", [9, 1])
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-10),
                                       (torch.float32, 1e-3)])
@pytest.mark.parametrize("opts", NODES_OPTS, ids=str)
def test_stage_ho_nodes_matches_reference(dim, n, mesh_order, seed, dtype,
                                          tol, opts):
    """Kernel 5 vs its plain version at p=3 (`_stage_ho_nodes_case`), with
    each option, at mesh order 2 (the compiled sizes) and 1 and 3 (the
    runtime sizes of the mesh geometry). In f64 du is held to the plain
    version at 1e-10 of max|du|. In f32 it is held to the f64 plain result
    at 1e-3 of max|du|: the f32 Bernstein mass inverse (condition ~4.3e4)
    amplifies rounding, most without the face flux, where on these small
    meshes the kernel's fixed-order sums and the plain version's library
    products need not agree to 2e-4 with each other; a lost Jacobi sweep
    moves du by ~2.5e-3. wdet is held to the plain version in the working
    type. The moved nodes (x0 + 0.3 v) put v . n off zero on every face
    type, with both modes."""
    _cuda()
    adv, xs, tb, tb64 = _nodes_operator(dim, n, 3, mesh_order, dtype)
    _stage_ho_nodes_case(adv, xs, tb, tb64, seed, opts, tol, False)


@pytest.mark.gpu
@pytest.mark.parametrize("dim,n", [(3, 8), (2, 9), (3, 5)])
@pytest.mark.parametrize("p", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-10),
                                       (torch.float32, 2e-4)])
@pytest.mark.parametrize("rhs_rows,n_iter", [("one zero", 16),
                                             ("every 7th zero", 16),
                                             ("every 7th zero", 2),
                                             ("one zero", 0)])
def test_gl_cg_matches_reference(dim, n, p, dtype, tol, rhs_rows, n_iter):
    """Kernel 6 vs its plain version on a random right-hand side at order
    p (1 and 5: the runtime sizes), with zero rows (rr0 = 0: stopped from
    the start; their result is 0); n_iter = 2 stops elements before they
    converge, n_iter = 0 gives x = 0. 125 and 81 elements leave a ragged
    last tile."""
    _cuda()
    adv, xs, _, _ = _nodes_operator(dim, n, p, 2, dtype)
    wdet = wd.wdet_reference(xs, adv._wdet_tables)
    rng = np.random.default_rng(10 + p)
    rhs = torch.as_tensor(rng.standard_normal((xs.shape[0], adv.disc.nd)),
                          dtype=dtype, device="cuda")
    zero = [3] if rhs_rows == "one zero" else list(range(0, xs.shape[0], 7))
    rhs[zero] = 0.0
    tb = adv._stage_tables
    before = cg.gl_cg.launches
    got = cg.gl_cg(rhs, wdet, tb, n_iter=n_iter)
    torch.cuda.synchronize()
    assert cg.gl_cg.launches == before + 1
    ref, its = cg.gl_cg_reference(rhs, wdet, tb, n_iter=n_iter,
                                  with_iterations=True)
    assert int(its[zero].max()) == 0
    assert float(got[zero].abs().max()) == 0.0
    if n_iter == 0:
        assert float(got.abs().max()) == 0.0
        return
    assert int(its.max()) > 1
    assert (got - ref).abs().max().item() <= tol * ref.abs().max().item()


@pytest.mark.gpu
@pytest.mark.parametrize("shape,periodic", [
    ((8, 8, 8), (False, False, False)), ((8, 8, 8), (True, True, True)),
    ((5, 3, 7), (True, False, True)), ((8, 1), (True, True)),
    ((7, 5), (False, True))], ids=str)
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32,
                                   torch.float16])
def test_gather_nbr_bit_identical(shape, periodic, dtype):
    """Kernel 7 vs the plain structured gather, bit for bit, on layouts
    whose block size is and is not a multiple of 8, in three dtypes."""
    _cuda()
    from remhos_torch.dofmaps import build_dofmaps
    dm = build_dofmaps(len(shape), 3)
    rng = np.random.default_rng(11)
    u = torch.as_tensor(rng.standard_normal((int(np.prod(shape)), dm.nd)),
                        dtype=dtype, device="cuda")
    got = gn.gather_nbr(u, gn.GatherLayout(shape, periodic, dm.nbr_dof_local,
                                           "cuda"))
    ref = gn.gather_nbr_reference(u, shape, periodic, dm.nbr_dof_local)
    assert torch.equal(got, ref)


@pytest.mark.gpu
def test_trace_counts_equal_launch_counters():
    """The profiler's trace holds one device event of each kernel per
    launch (the kernels are launched through ctypes)."""
    _cuda()
    case = bench.build_case(n=6, order=3, dtype=torch.float32,
                            device="cuda", n_steps=4, dt=DT)
    adv = case.adv
    rng = np.random.default_rng(12)
    u = torch.as_tensor(rng.random(tuple(case.u0.shape)),
                        dtype=torch.float32, device="cuda")
    unbr = adv.gather_nbr(u).reshape(u.shape[0], -1)
    smin, smax = structured.overlap_stencil_T(
        *bounds.elements_min_max(u), adv.shape, adv.periodic, adv.masks)
    xs = (adv.x0_nodes + 0.3 * adv.v_nodes).contiguous()
    nf = Advection(adv.disc, SolverConfig(problem=10, ho=3, lo=3, fct=2,
                                          pa=True), adv.x0_nodes,
                   adv.v_nodes, dtype=torch.float32, device="cuda")
    tbn = shn.stage_ho_nodes_tables(adv.disc, torch.float32, "cuda")
    tbf = fa.fa_assemble_tables(adv.disc, torch.float32, "cuda")
    lay = gn.GatherLayout(adv.shape, adv.periodic,
                          adv.disc.dofmaps.nbr_dof_local, "cuda")

    def every_kernel():
        for _ in range(2):
            ms.mega_stage(0.1, DT, u, unbr, smin, smax, adv._poly,
                          adv._stage_tables)
        sh.stage_ho(0.1, u, unbr, adv._poly, adv._stage_tables)
        wdet = wd.wdet(xs, adv._wdet_tables)
        gc.geom_conv(xs, adv.v_nodes, u, nf._gc_tables, 1.0)
        shn.stage_ho_nodes(xs, adv.v_nodes, u, unbr, tbn, mode=1.0)
        cg.gl_cg(u, wdet, adv._stage_tables)
        gn.gather_nbr(u, lay)
        fa.fa_assemble(xs, adv.v_nodes, tbf)

    every_kernel()
    tr, launches = trc.capture_counted(every_kernel)
    events = trc.check_kernel_events(tr, launches, "test")
    assert events == dict(dict.fromkeys(ops.KERNELS, 1), mega_stage=2)
    rep = trc.loop_report(tr, 1, 1)
    assert rep["kernel_calls"] == len(ops.KERNELS) + 1
    assert 0.0 <= rep["idle_share"] < 1.0


def _f64(*tensors):
    return [x.to(torch.float64) for x in tensors]


@pytest.mark.gpu
@pytest.mark.parametrize("p", [1, 2, 4, 5])
@pytest.mark.parametrize("dim,n", [(3, 5), (2, 9)])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_stage_kernels_at_other_orders(p, dim, n, dtype):
    """Kernels 1 and 2 (with LO) at p = 1, 2, 4 and 5 (p = 1 and 5: the
    core's runtime-size instantiation) against their plain versions: in f64
    at 1e-10 of max|du|; in f32 against the plain version evaluated in f64
    on the same inputs with the kernel's one Jacobi sweep, at 2e-4 (du_LO
    always), but du in 3D at p = 4 at kernel 5's f32 small-mesh rule, 1e-3,
    and at p = 5 no farther than the f32 plain version (f32 rounding,
    amplified by the Bernstein mass inverse, puts neither the kernel nor
    the plain version within 2e-4 there; chip_smoke.stage_limit). Where the
    f32 limit is a number, one Jacobi sweep fewer must move the f64 du_HO
    by more than it on these meshes. wdet at the wdet limits. 125 and 81
    elements leave a ragged last tile."""
    _cuda()
    case = bench.build_case(n=n, order=p, dtype=torch.float32, device="cuda",
                            n_steps=4, dt=DT, dim=dim)
    adv = case.adv if dtype == torch.float32 else case.adv64
    tb, tb64, P = adv._stage_tables, case.adv64._stage_tables, adv._poly
    rng = np.random.default_rng(20 + p)
    u = torch.as_tensor(rng.random((P.shape[0], tb["nd"])), dtype=dtype,
                        device="cuda")
    unbr = adv.gather_nbr(u).reshape(u.shape[0], -1)
    smin, smax = structured.overlap_stencil_T(
        *bounds.elements_min_max(u), adv.shape, adv.periodic, adv.masks)
    n_cg = ms.default_sweeps(dtype)
    u64, unbr64, smin64, smax64, P64 = _f64(u, unbr, smin, smax, P)
    t = float(torch.tensor(0.1, dtype=dtype))
    dt = float(torch.tensor(DT, dtype=dtype))
    tol, wtol = (2e-4, 1e-5) if dtype == torch.float32 else (1e-10, 1e-12)
    got = ms.mega_stage(t, dt, u, unbr, smin, smax, P, tb)
    ho = sh.stage_ho(t, u, unbr, P, tb, dt=dt, with_lo=True)
    torch.cuda.synchronize()
    ref = ms.mega_stage_reference(t, dt, u64, unbr64, smin64, smax64, P64,
                                  tb64, n_cg)
    ho_ref = sh.stage_ho_poly_reference(t, u64, unbr64, P64, tb64, n_cg,
                                        dt=dt, with_lo=True)

    def rel(g, r):
        return (g.double() - r).abs().max().item() / r.abs().max().item()

    tols = [tol, tol]
    if dtype == torch.float32 and dim == 3 and p == 4:
        tols = [1e-3, 1e-3]
    elif dtype == torch.float32 and dim == 3 and p >= 5:
        tols = [rel(ms.mega_stage_reference(t, dt, u, unbr, smin, smax, P,
                                            tb, n_cg), ref),
                rel(sh.stage_ho_poly_reference(t, u, unbr, P, tb, n_cg)[0],
                    ho_ref[0])]
    for g, r, lim in zip([got, *ho], [ref, *ho_ref], tols + [wtol, tol]):
        assert rel(g, r) <= lim
    if dtype == torch.float32 and not (dim == 3 and p >= 5):
        Ku, wdet = core.poly_stage_core_reference(t, u64, unbr64, P64, tb64, 0)
        lost = core.jacobi_gl_inverse(Ku, wdet, tb64, n_cg - 1)
        assert rel(lost, ho_ref[0]) > tols[1]


@pytest.mark.gpu
@pytest.mark.parametrize("p", [1, 2, 4, 5])
@pytest.mark.parametrize("dim,n", [(3, 8), (2, 9)])
@pytest.mark.parametrize("mesh_order", [2, 1, 3])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("opts", NODES_OPTS, ids=str)
def test_stage_ho_nodes_at_other_orders(p, dim, n, mesh_order, dtype, opts):
    """Kernel 5 at p = 1, 2, 4 and 5, mesh orders 2, 1 and 3, with each
    option, against its plain version with the rule of
    test_stage_ho_nodes_matches_reference: f64 at 1e-10 of max|du|; f32
    against the f64 plain result at 1e-3; wdet in the working type. In 3D
    the Bernstein mass inverse amplifies rounding most at high p and
    without the face flux: in f32 at p = 5, and at p = 4 without the face
    flux, where the f32 plain result itself lies 2-7e-2 and ~4e-3 from the
    f64 one, du is held no farther from it than the f32 plain result
    (chip_smoke.stage_limit's rule at p = 5); in f64 at p = 5 without the
    face flux, where the f64 plain result's dense sums lie 1.2-2.3e-10 from
    an extended-precision evaluation (the kernel 0.25-1.2e-10), du is held
    to that evaluation (`_extended_du`) at 1e-10, or no farther than the
    f64 plain result where that lies farther."""
    _cuda()
    adv, xs, tb, tb64 = _nodes_operator(dim, n, p, mesh_order, dtype)
    tol = 1e-10 if dtype == torch.float64 else 1e-3
    hard = dim == 3 and (p >= 5 or (p == 4 and "with_face" in opts))
    _stage_ho_nodes_case(
        adv, xs, tb, tb64, 30 + p, opts, tol,
        dtype == torch.float32 and hard,
        dtype == torch.float64 and dim == 3 and p >= 5 and "with_face" in opts)


@pytest.mark.gpu
def test_gather_nbr_second_layout_on_card():
    """Layouts on the card: a call with a second layout after the first
    gives the second layout's answer, and again the first's."""
    _cuda()
    from remhos_torch.dofmaps import build_dofmaps
    dm = build_dofmaps(3, 3)
    rng = np.random.default_rng(13)
    for shape, periodic in [((4, 3, 2), (False,) * 3), ((2, 3, 4), (True,) * 3),
                            ((4, 3, 2), (False,) * 3)]:
        u = torch.as_tensor(rng.standard_normal((24, dm.nd)), device="cuda")
        got = gn.gather_nbr(u, gn.GatherLayout(shape, periodic,
                                               dm.nbr_dof_local, "cuda"))
        assert torch.equal(got, gn.gather_nbr_reference(
            u, shape, periodic, dm.nbr_dof_local))


@pytest.mark.gpu
@pytest.mark.parametrize("dim,n", [(3, 5), (2, 9)])
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-10),
                                       (torch.float32, 2e-4)])
def test_per_dof_kernel_matches_reference(dim, n, dtype, tol):
    """Kernel 1's per-dof variant on the sparsity bounds of -bt 1 against
    its plain version (tolerances as test_kernel_matches_reference), and on
    the "T" stencil expanded to dofs against the "T" variant; its own
    launch counter advances, the "T" one's does not."""
    _cuda()
    from remhos_torch import dofmaps
    case = bench.build_case(n=n, order=3, dtype=dtype, device="cuda",
                            n_steps=4, dt=DT, dim=dim)
    adv = case.adv
    rng = np.random.default_rng(17)
    u = torch.as_tensor(rng.random(tuple(case.u0.shape)), dtype=dtype,
                        device="cuda")
    unbr = adv.gather_nbr(u).reshape(u.shape[0], -1)
    el = bounds.elements_min_max(u)
    topo = dofmaps.bounds_topology(adv.disc.mesh, adv.disc.p, "cuda")
    xmin, xmax = bounds.sparsity_bounds(*el, topo.nbr_elem, topo.nd)
    with pytest.raises(ValueError, match="contiguous"):
        ms.mega_stage(0.1, DT, u, unbr, xmin, xmax, adv._poly,
                      adv._stage_tables, bounds="dof")
    xmin, xmax = xmin.contiguous(), xmax.contiguous()
    args = (0.1, DT, u, unbr, xmin, xmax, adv._poly, adv._stage_tables)
    before = dict(ms.mega_stage.variant_launches)
    got = ms.mega_stage(*args, bounds="dof")
    torch.cuda.synchronize()
    assert ms.mega_stage.variant_launches == dict(before,
                                                  dof=before["dof"] + 1)
    ref = ms.mega_stage_reference(*args, ms.default_sweeps(dtype), "dof")
    err = (got - ref).abs().max().item()
    assert err <= tol * ref.abs().max().item()
    smin, smax = structured.overlap_stencil_T(*el, adv.shape, adv.periodic,
                                              adv.masks)
    cls = adv._stage_tables["cls"].long()
    du_T = ms.mega_stage(0.1, DT, u, unbr, smin, smax, adv._poly,
                         adv._stage_tables)
    du_dof = ms.mega_stage(0.1, DT, u, unbr, smin[cls].T.contiguous(),
                           smax[cls].T.contiguous(), adv._poly,
                           adv._stage_tables, bounds="dof")
    err = (du_T - du_dof).abs().max().item()
    assert err <= tol * du_T.abs().max().item()


@pytest.mark.gpu
def test_short_path_f_runs_the_per_dof_variant():
    """-bt 1 on the mega path through driver.run: every stage one launch of
    kernel 1's per-dof variant."""
    _cuda()
    ops.reset_launch_counts()
    res = driver.run(RunConfig(
        mesh="default", dim=3, elem_per_shard=64, order=3, problem=10, ho=3,
        lo=5, fct=2, pa=True, bounds_type=1, dtype="float32", t_final=0.7,
        dt=DT, max_tsteps=4, device="cuda", verbose=False))
    assert res.steps == 4
    assert ops.variant_counts()["mega_stage"] == dict(T=0, E=0, dof=12,
                                                      P16=0)
    assert ops.launch_counts()["mega_stage"] == 12
    assert res.min_u >= res.u0_min - 1e-5 and res.max_u <= res.u0_max + 1e-5


@pytest.mark.gpu
def test_fa_path_runs_on_the_card_without_kernels():
    """The assembled path on a CUDA operator: its tensors on the card, no
    kernel launched but `fa_assemble`, once an assembly (3 stages a step
    and the two mass reports), the same run as on the CPU to 1e-12 in
    f64."""
    _cuda()
    kw = dict(mesh="cube01_hex", problem=10, rs_levels=0, order=2, dt=0.02,
              t_final=0.7, max_tsteps=4, ho=3, lo=1, fct=1, verbose=False)
    adv, _ = driver.build_operator(RunConfig(device="cuda", **kw))
    assert adv.geometry(0.1)["K_elem"].device.type == "cuda"
    ops.reset_launch_counts()
    rc = driver.run(RunConfig(device="cuda", **kw))
    rh = driver.run(RunConfig(device="cpu", **kw))
    assert ops.launch_counts() == dict(dict.fromkeys(ops.KERNELS, 0),
                                       fa_assemble=3 * rc.steps_total + 2)
    assert abs(rc.final_mass_u - rh.final_mass_u) <= 1e-12 * rh.final_mass_u
    assert abs(rc.max_u - rh.max_u) <= 1e-12 * rh.max_u


@pytest.mark.gpu
@pytest.mark.parametrize("t", [0.0, 0.3])
def test_fa_stage_matches_the_cpu(t):
    """One limited stage of the benchmark's assembled configuration (`-ho 3
    -lo 1 -fct 1`, float64, p=2) at 8^3 on the card against the CPU, from a
    seeded u, to 1e-12 of max|du| (round-off: the card's batched Cholesky
    and index_add sum in another order)."""
    _cuda()
    mesh = make_cartesian_mesh(3, (8,) * 3, (0.0,) * 3, (1.0,) * 3,
                               (False,) * 3)
    disc = build_discretization(mesh, 2)
    cfg = SolverConfig(problem=10, ho=3, lo=1, fct=1, pa=False)
    x0 = torch.as_tensor(mesh.x, dtype=torch.float64)
    v = driver.integrate_mesh_velocity(x0, 10, mesh.bb_min, mesh.bb_max,
                                       0.7, 0.01)
    g = torch.Generator().manual_seed(3)
    u = torch.rand((1, 512, disc.nd), generator=g, dtype=torch.float64)
    du = {}
    for dev in ("cpu", "cuda"):
        adv = Advection(disc, cfg, x0.to(dev), v.to(dev),
                        dtype=torch.float64, device=dev)
        before = fa.fa_assemble.launches
        du[dev] = adv.stage_function()(t, 0.01, u.to(dev))[0].cpu()
        # the card's stage takes its element matrices from one launch
        assert fa.fa_assemble.launches == before + (dev == "cuda")
    ref = du["cpu"]
    assert (du["cuda"] - ref).abs().max() <= 1e-12 * ref.abs().max()


def _fa_moving_mesh(dim, p, dtype, t):
    """A curved mesh of 3^3 (5^2) elements, mesh order 2, moved to
    pseudo-time t by a random nodal velocity: (tables, tables in f64, xs,
    v, xs in f64, v in f64), on the card."""
    n = 3 if dim == 3 else 5
    mesh = make_cartesian_mesh(dim, (n,) * dim, (0.0,) * dim, (1.0,) * dim,
                               (False,) * dim)
    disc = build_discretization(mesh, p)
    rng = np.random.default_rng(10 * dim + p)
    x0 = mesh.x + 0.03 * np.sin(3.0 * mesh.x[..., ::-1])
    v = 0.3 * rng.standard_normal(mesh.x.shape)
    xs64 = torch.as_tensor(x0 + t * v, dtype=torch.float64, device="cuda")
    v64 = torch.as_tensor(v, dtype=torch.float64, device="cuda")
    return (fa.fa_assemble_tables(disc, dtype, "cuda"),
            fa.fa_assemble_tables(disc, torch.float64, "cuda"),
            xs64.to(dtype).contiguous(), v64.to(dtype).contiguous(), xs64,
            v64)


@pytest.mark.gpu
@pytest.mark.parametrize("t", [0.0, 0.5])
@pytest.mark.parametrize("p", [2, 3, 4])
@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-13),
                                       (torch.float32, 1e-5)])
def test_fa_assemble_matches_reference(dim, p, dtype, tol, t):
    """The assembled stage's kernel on a moving curved mesh (27 or 25
    elements: a ragged last tile) against its plain chain evaluated in f64:
    det J, M, ml, K and the face blocks, each to `tol` of its largest
    entry; one launch counted."""
    _cuda()
    tb, tb64, xs, v, xs64, v64 = _fa_moving_mesh(dim, p, dtype, t)
    assert tb["engaged"]
    before = fa.fa_assemble.launches
    got = fa.fa_assemble(xs, v, tb)
    torch.cuda.synchronize()
    assert fa.fa_assemble.launches == before + 1
    ref = fa.fa_assemble_reference(xs64, tb64, 1,
                                   geometry.interp_nodes(v64, tb64["Bm"]),
                                   geometry.face_velocity(v64, tb64["Bmf"]))
    for name, g, r in zip(("detJ", "M", "ml", "K", "bdrInt"), got, ref):
        assert g.shape == r.shape and g.dtype == dtype, name
        err = (g.to(torch.float64) - r).abs().max().item()
        assert err <= tol * r.abs().max().item(), name


@pytest.mark.gpu
def test_failed_build_raises(tmp_path, monkeypatch):
    """A kernel source that does not compile makes the wrapper raise: no
    fallback to the plain version."""
    _cuda()
    from remhos_torch.ops import build
    src = tmp_path / "csrc"
    src.mkdir()
    for f in build.CSRC.iterdir():
        (src / f.name).write_bytes(f.read_bytes())
    cu = src / "mega_stage.cu"
    cu.write_text(cu.read_text() + "\nthis is not C++;\n")
    monkeypatch.setattr(build, "CSRC", src)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(build, "_LOADED", {})
    case = bench.build_case(n=3, order=3, dtype=torch.float32,
                            device="cuda", n_steps=4, dt=DT)
    adv = case.adv
    u = case.u0
    unbr = adv.gather_nbr(u).reshape(u.shape[0], -1)
    x = torch.zeros_like(u)
    tables = {k: v for k, v in adv._stage_tables.items()
              if not (isinstance(k, tuple) and k[0] == "launcher")}
    with pytest.raises(RuntimeError, match="nvcc failed"):
        ms.mega_stage(0.1, DT, u, unbr, x, x, adv._poly, tables,
                      bounds="dof")


@pytest.mark.gpu
@pytest.mark.parametrize("mono,si", [(2, 2), (1, 1)])
def test_short_path_h_matches_the_cpu(mono, si):
    """Path H cut to a 24x24 mesh and 4 steps: -mono -si on the card, no
    kernel launched, the same run as on the CPU to 1e-12 in f64, with
    path H's gates."""
    _cuda()
    kw = dict(mesh="periodic-square", problem=4, rs_levels=3, order=2,
              dt=0.005, t_final=0.03, max_tsteps=4, ho=0, lo=0, fct=0,
              mono=mono, smth_ind=si, verbose=False)
    ops.reset_launch_counts()
    rc = driver.run(RunConfig(device="cuda", **kw))
    rh = driver.run(RunConfig(device="cpu", **kw))
    assert set(ops.launch_counts().values()) == {0}
    assert abs(rc.final_mass_u - rh.final_mass_u) <= 1e-12 * rh.final_mass_u
    assert abs(rc.max_u - rh.max_u) <= 1e-12 * rh.max_u
    assert rc.mass_loss_u < 1e-11 and rc.max_u <= 1.0 + 1e-9


@pytest.mark.gpu
def test_short_path_i_matches_the_cpu():
    """Path I cut to 32 elements and 20 steps: 1D -ho 3 -lo 4 -fct 2 on the
    card, no kernel launched, the same run as on the CPU to 1e-12 in f64;
    in f32 the repaired residual distribution keeps its bounds."""
    _cuda()
    kw = dict(mesh="periodic-segment", problem=0, rs_levels=3, order=3,
              dt=0.001, t_final=1.0, max_tsteps=20, ho=3, lo=4, fct=2,
              verbose=False)
    ops.reset_launch_counts()
    rc = driver.run(RunConfig(device="cuda", **kw))
    rh = driver.run(RunConfig(device="cpu", **kw))
    assert set(ops.launch_counts().values()) == {0}
    assert abs(rc.final_mass_u - rh.final_mass_u) <= 1e-12 * rh.final_mass_u
    assert abs(rc.max_u - rh.max_u) <= 1e-12 * rh.max_u
    assert rc.mass_loss_u < 1e-13 and rc.max_u <= 1.0 + 1e-10
    r32 = driver.run(RunConfig(device="cuda", dtype="float32", **kw))
    assert r32.max_u <= 1.0 + 1e-6 and r32.mass_closure_injected_rel < 1e-4


@pytest.mark.gpu
def test_mono_loop_does_not_depend_on_its_exit_interval(monkeypatch):
    """The inner consistent-mass loop tests its exit every k iterations on
    the card: the same bits for k = 1, 8 and past the cap."""
    _cuda()
    from remhos_torch import mono
    cfg = RunConfig(mesh="periodic-square", problem=4, rs_levels=3, order=2,
                    dt=0.005, ho=0, lo=0, fct=0, mono=2, smth_ind=2,
                    device="cuda", verbose=False)
    adv, dt = driver.build_operator(cfg)
    mesh = adv.disc.mesh
    u, _ = driver.project_bernstein(
        adv.x0_nodes, adv.disc.Bm_at_unodes,
        lambda x: prob.u0_function(4, x, mesh.bb_min, mesh.bb_max))
    geom = adv.geometry(0.0)
    outs = []
    for k in (1, mono.CHECK_EVERY, mono.MAX_ITER + 1):
        monkeypatch.setattr(mono, "CHECK_EVERY", k)
        outs.append(mono.mono_rd_solution(adv, geom, u, dt))
    for o in outs[1:]:
        assert torch.equal(o, outs[0])
    assert adv.mono_stats["solves"] == 3


def _rotated_box_file(path, n, seed):
    """An n^3 unit box as a general hex mesh whose elements' corner frames
    are turned by random cube rotations, written by the port's writer."""
    import itertools
    from remhos_torch import umesh3d, vis
    box = make_cartesian_mesh(3, (n,) * 3, (0.0,) * 3, (1.0,) * 3,
                              (False,) * 3)
    corners, _ = vis._structured_corner_ids(box)
    pos = box.x[:, [0, 2, 6, 8, 18, 20, 24, 26]]
    rots = [R for R in (np.eye(3)[list(p)] * np.array(s)[:, None]
                        for p in itertools.permutations(range(3))
                        for s in itertools.product((1, -1), repeat=3))
            if np.linalg.det(R) > 0]
    ref = np.stack([(np.arange(8) >> d) & 1 for d in range(3)], -1) - 0.5
    rng = np.random.default_rng(seed)
    for e in range(len(corners)):
        R = rots[rng.integers(len(rots))]
        old = ((ref @ R.T) > 0).astype(int) @ np.array([1, 2, 4])
        corners[e], pos[e] = corners[e][old], pos[e][old]
    mesh = umesh3d.from_arrays_3d(corners, pos, 2)
    Path(path).write_text(vis.mfem_mesh_text(mesh, mesh.x))


@pytest.mark.gpu
@pytest.mark.parametrize("lo,ho", [(5, 3), (4, 2)])
def test_general_mesh_run_matches_the_cpu(lo, ho, tmp_path):
    """A rotated 4^3 box read by path: the card's run (kernel 1's per-dof
    variant, or kernels 3 and 4) equals the CPU's plain run and the
    structured grid's to 1e-12."""
    _cuda()
    path = tmp_path / "box.mesh"
    _rotated_box_file(path, 4, 3)
    kw = dict(problem=10, order=3, ho=ho, lo=lo, fct=2, pa=True, dt=DT,
              t_final=0.7, max_tsteps=6, verbose=False)
    ops.reset_launch_counts()
    rc = driver.run(RunConfig(mesh=str(path), rs_levels=0, device="cuda",
                              **kw))
    n = ops.launch_counts()
    if lo == 5:
        assert n["mega_stage"] == 18
        assert ops.variant_counts()["mega_stage"] == dict(
            T=0, E=0, dof=18, P16=0)
    else:
        assert n["geom_conv"] == 36 and n["wdet"] == 20
    rh = driver.run(RunConfig(mesh=str(path), rs_levels=0, device="cpu",
                              **kw))
    rs = driver.run(RunConfig(mesh="default", dim=3, elem_per_shard=64,
                              device="cuda", **kw))
    for r in (rh, rs):
        assert abs(rc.final_mass_u - r.final_mass_u) <= 1e-12 * r.final_mass_u
        assert abs(rc.max_u - r.max_u) <= 1e-11


@pytest.mark.gpu
@pytest.mark.parametrize("p", [2, 3, 4])
@pytest.mark.parametrize("dim,n", [(3, 5), (2, 9)])
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-10),
                                       (torch.float32, 2e-4)])
def test_element_major_variant(p, dim, n, dtype, tol):
    """Kernel 1's "E" variant (the element-major [E, 3^dim] stencil of a
    sharded grid) equals the "T" variant bit for bit on the same stencil
    values, and its plain version within the "T" limits: in f32 the plain
    version evaluated in f64 on the same inputs, at 2e-4, and in 3D at p=4
    at 1e-3 (test_stage_kernels_at_other_orders' limits)."""
    _cuda()
    case = bench.build_case(n=n, order=p, dtype=torch.float32, device="cuda",
                            n_steps=4, dt=DT, dim=dim)
    adv = case.adv if dtype == torch.float32 else case.adv64
    rng = np.random.default_rng(23)
    u = torch.as_tensor(rng.random(tuple(case.u0.shape)), dtype=dtype,
                        device="cuda")
    unbr = adv.gather_nbr(u).reshape(u.shape[0], -1)
    el = bounds.elements_min_max(u)
    smin, smax = structured.overlap_stencil_T(*el, adv.shape, adv.periodic,
                                              adv.masks)
    emin, emax = adv.compute_bounds_stencil(*el)
    assert torch.equal(emin, smin.T) and torch.equal(emax, smax.T)
    tail = (adv._poly, adv._stage_tables)
    before = dict(ms.mega_stage.variant_launches)
    du_E = ms.mega_stage(0.1, DT, u, unbr, emin, emax, *tail, bounds="E")
    du_T = ms.mega_stage(0.1, DT, u, unbr, smin, smax, *tail)
    torch.cuda.synchronize()
    assert ms.mega_stage.variant_launches == dict(
        before, E=before["E"] + 1, T=before["T"] + 1)
    assert torch.equal(du_E, du_T)
    t = float(torch.tensor(0.1, dtype=dtype))
    dt = float(torch.tensor(DT, dtype=dtype))
    ref = ms.mega_stage_reference(t, dt, *_f64(u, unbr, emin, emax, adv._poly),
                                  case.adv64._stage_tables,
                                  ms.default_sweeps(dtype), "E")
    if dtype == torch.float32 and dim == 3 and p == 4:
        tol = 1e-3
    err = (du_E.double() - ref).abs().max().item()
    assert err <= tol * ref.abs().max().item()


@pytest.mark.gpu
@pytest.mark.parametrize("dim,n", [(3, 5), (2, 9)])
def test_p16_kernels_match_their_plain_versions(dim, n):
    """Kernels 1 and 2 reading the bf16 va/vn stream (f32) against their
    P16 plain versions evaluated in f64 on the same bf16 values; an f64
    launch with P16 raises."""
    _cuda()
    case = bench.build_case(n=n, order=3, dtype=torch.float32,
                            device="cuda", n_steps=4, dt=DT, dim=dim)
    adv, tb = case.adv, case.adv._stage_tables
    P, P16 = tables_p16(adv)
    rng = np.random.default_rng(29)
    u = torch.as_tensor(rng.random(tuple(case.u0.shape)),
                        dtype=torch.float32, device="cuda")
    unbr = adv.gather_nbr(u).reshape(u.shape[0], -1)
    smin, smax = structured.overlap_stencil_T(
        *bounds.elements_min_max(u), adv.shape, adv.periodic, adv.masks)
    before = dict(ms.mega_stage.variant_launches)
    got = ms.mega_stage(0.1, DT, u, unbr, smin, smax, P, tb, P16=P16)
    assert ms.mega_stage.variant_launches == dict(
        before, T=before["T"] + 1, P16=before["P16"] + 1)
    tb64 = case.adv64._stage_tables
    f = [x.double() for x in (u, unbr, smin, smax, P)]
    ref = ms.mega_stage_reference(as_f32(0.1), as_f32(DT), f[0], f[1], f[2],
                                  f[3], f[4], tb64, 1, "T", P16)
    err = (got.double() - ref).abs().max().item()
    assert err <= 2e-4 * ref.abs().max().item()
    n16 = sh.stage_ho.variant_launches["P16"]
    du, wdet, lo = sh.stage_ho(0.1, u, unbr, P, tb, dt=DT, with_lo=True,
                               P16=P16)
    assert sh.stage_ho.variant_launches["P16"] == n16 + 1
    rdu, rw, rlo = sh.stage_ho_poly_reference(as_f32(0.1), f[0], f[1], f[4],
                                              tb64, 1, dt=as_f32(DT),
                                              with_lo=True, P16=P16)
    for a, b in ((du, rdu), (lo, rlo)):
        err = (a.double() - b).abs().max().item()
        assert err <= 2e-4 * b.abs().max().item()
    err = (wdet.double() - rw).abs().max().item()
    assert err <= 1e-5 * rw.abs().max().item()
    with pytest.raises(TypeError, match="float32 only"):
        ms.mega_stage(0.1, DT, u.double(), unbr.double(), smin.double(),
                      smax.double(), P.double(), tb64, P16=P16)


def as_f32(x):
    return float(torch.tensor(x, dtype=torch.float32))


def tables_p16(adv):
    """(P, P16) of an f32 operator's nodes and velocity (the bf16 stream)."""
    from remhos_torch.ops import tables as tbl
    return tbl.build_poly_tables(adv.x0_nodes, adv.v_nodes, adv.disc,
                                 va_vn_bf16=True)


@pytest.mark.gpu
def test_one_rank_nccl_sharded_run():
    """A sharded run of one rank (NCCL, in this process) equals the
    unsharded run, through kernel 1's "E" variant only."""
    _cuda()
    kw = dict(mesh="default", dim=3, elem_per_shard=64, order=3, problem=10,
              ho=3, lo=5, fct=2, pa=True, t_final=0.7, dt=DT, max_tsteps=4,
              device="cuda", verbose=False)
    r1 = driver.run(RunConfig(**kw))
    ops.reset_launch_counts()
    rs = driver.run(RunConfig(shard_grid=(1,), **kw))
    assert ops.variant_counts()["mega_stage"] == dict(T=0, E=12, dof=0,
                                                      P16=0)
    assert abs(rs.final_mass_u - r1.final_mass_u) <= 1e-13
    assert abs(rs.max_u - r1.max_u) <= 1e-13


@pytest.mark.gpu
def test_graft_entry_runs_on_the_card():
    """`graft_entry.entry()` with no device builds its state and operator
    on the card; its step equals the CPU step of the same state (1e-12 of
    max|S|: the assembled path's Cholesky solves round differently)."""
    _cuda()
    from remhos_torch import graft_entry
    fn, args = graft_entry.entry()
    assert args[0].device.type == "cuda"
    out = fn(*args)
    assert out.device.type == "cuda" and torch.isfinite(out).all()
    fn_c, args_c = graft_entry.entry("cpu")
    ref = fn_c(*args_c)
    assert (out.cpu() - ref).abs().max() <= 1e-12 * ref.abs().max()


@pytest.mark.gpu
def test_graft_dryrun_multichip_on_the_card():
    """`graft_entry.dryrun_multichip(4)` with no device: four gloo ranks
    sharing the card (a 2 x 2 shard grid), each leg < 1e-13 of the
    unsharded step on the card."""
    _cuda()
    from remhos_torch import graft_entry
    out = graft_entry.dryrun_multichip(4)
    assert out["grid"] == (2, 2)
    for k in ("plain", "production", "weak_scaling", "general_mesh"):
        assert out[k] < 1e-13
