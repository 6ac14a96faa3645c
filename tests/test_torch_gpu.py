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

from remhos_torch import bench, bounds, driver, structured
from remhos_torch.config import RunConfig
from remhos_torch.operator import Advection, SolverConfig
from remhos_torch import ops
from remhos_torch.ops import gather_nbr as gn
from remhos_torch.ops import geom_conv as gc
from remhos_torch.ops import gl_cg as cg
from remhos_torch.ops import mega_stage as ms
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
    benchmark's mesh motion, or the operator of a named golden row (the
    `remap-cube3d-*pa` rows: their own mesh, p=2)."""
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


SHAPES = [(3, 5), (2, 9), "remap-cube3d-m3pa"]


@pytest.mark.gpu
@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12),
                                       (torch.float32, 1e-5)])
def test_wdet_matches_reference(shape, dtype, tol):
    """The wdet kernel vs its plain version on moved nodes; 125 and 81
    elements leave a ragged last tile of its 8-element blocks, and the
    golden row's mesh gives it p=2."""
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
@pytest.mark.parametrize("dtype,tol,wtol", [(torch.float64, 1e-12, 1e-12),
                                            (torch.float32, 1e-5, 1e-5)])
@pytest.mark.parametrize("sign", [1.0, -1.0])
def test_geom_conv_matches_reference(shape, dtype, tol, wtol, sign):
    """The geom_conv kernel vs its plain version on moved nodes, the mesh
    velocity and a random u: Ku and wdet; 125 and 81 elements leave a ragged
    last block, and the golden row's mesh gives it p=2. Tolerances as in
    chip_smoke.py."""
    _cuda()
    adv = _nonfused_operator(shape, dtype)
    xs = adv.x0_nodes + 0.3 * adv.v_nodes
    rng = np.random.default_rng(9)
    u = torch.as_tensor(rng.random((xs.shape[0], adv.disc.nd)), dtype=dtype,
                        device="cuda")
    before = gc.geom_conv.launches
    got = gc.geom_conv(xs, adv.v_nodes, u, adv._gc_tables, sign)
    torch.cuda.synchronize()
    assert gc.geom_conv.launches == before + 1
    ref = gc.geom_conv_reference(xs, adv.v_nodes, u, adv._gc_tables, sign)
    for g, r, lim in zip(got, ref, (tol, wtol)):
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
    r = driver.run(RunConfig(ode_solver=3, dtype="float32", max_tsteps=8,
                             **PATH))
    m1, h1, w1 = _counts()
    assert (m1 - m0, h1 - h0, w1 - w0) == (0, 2 * 3 * r.steps_total, 2)
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
    stage one wdet and three geom_conv launches and two CG solves."""
    _cuda()
    m0, h0, w0 = _counts()
    g0 = gc.geom_conv.launches
    r = driver.run(RunConfig(ode_solver=3, dtype="float32", max_tsteps=8,
                             **dict(PATH, lo=3)))
    m1, h1, w1 = _counts()
    assert (m1 - m0, h1 - h0, w1 - w0) == (0, 0, 3 * 8 + 2)
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


def _moved(dim, n, dtype):
    """The benchmark's operator at n^dim and its nodes x0 + 0.3 v."""
    adv = bench.build_case(n=n, order=3, dtype=dtype, device="cuda",
                           n_steps=4, dt=DT, dim=dim).adv
    return adv, (adv.x0_nodes + 0.3 * adv.v_nodes).contiguous()


@pytest.mark.gpu
@pytest.mark.parametrize("dim,n", [(3, 8), (2, 9), (3, 12)])
@pytest.mark.parametrize("seed", [9, 1])
@pytest.mark.parametrize("dtype,tol,wtol", [(torch.float64, 1e-10, 1e-12),
                                            (torch.float32, 1e-3, 1e-5)])
@pytest.mark.parametrize("opts", [{}, dict(n_cg=0), dict(with_face=False),
                                  dict(mode=-1.0)], ids=str)
def test_stage_ho_nodes_matches_reference(dim, n, seed, dtype, tol, wtol,
                                          opts):
    """Kernel 5 vs its plain version: du (Ku with n_cg=0) and wdet, with
    each option. In f64 du is held to the plain version at 1e-10 of
    max|du|. In f32 it is held to the f64 plain result at 1e-3 of max|du|:
    the f32 Bernstein mass inverse (condition ~4.3e4) amplifies rounding,
    most without the face flux, where on these small meshes the kernel's
    fixed-order sums and the plain version's library products need not
    agree to 2e-4 with each other; a lost Jacobi sweep moves du by ~2.5e-3.
    wdet is held to the plain version in the working type."""
    _cuda()
    adv, xs = _moved(dim, n, dtype)
    tb = shn.stage_ho_nodes_tables(adv.disc, dtype, "cuda")
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
    if dtype == torch.float32:
        d = torch.float64
        ref = (shn.stage_ho_nodes_reference(
            xs.to(d), adv.v_nodes.to(d), u.to(d), unbr.to(d),
            shn.stage_ho_nodes_tables(adv.disc, d, "cuda"), n_cg=n_cg,
            **kw)[0], ref[1])
        got = (got[0].double(), got[1])
    for g, r, lim in zip(got, ref, (tol, wtol)):
        assert (g - r).abs().max().item() <= lim * r.abs().max().item()


@pytest.mark.gpu
@pytest.mark.parametrize("dim,n", [(3, 8), (2, 9)])
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-10),
                                       (torch.float32, 2e-4)])
def test_gl_cg_matches_reference(dim, n, dtype, tol):
    """Kernel 6 vs its plain version on a random right-hand side, with an
    element whose right-hand side is 0 (stopped from the start)."""
    _cuda()
    adv, xs = _moved(dim, n, dtype)
    wdet = wd.wdet_reference(xs, adv._wdet_tables)
    rng = np.random.default_rng(10)
    rhs = torch.as_tensor(rng.standard_normal((xs.shape[0], adv.disc.nd)),
                          dtype=dtype, device="cuda")
    rhs[3] = 0.0
    tb = adv._stage_tables
    before = cg.gl_cg.launches
    got = cg.gl_cg(rhs, wdet, tb)
    torch.cuda.synchronize()
    assert cg.gl_cg.launches == before + 1
    ref, its = cg.gl_cg_reference(rhs, wdet, tb, with_iterations=True)
    assert int(its[3]) == 0 and int(its.max()) > 1
    assert float(got[3].abs().max()) == 0.0
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
    got = gn.gather_nbr(u, shape, periodic, dm.nbr_dof_local)
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

    def seven():
        for _ in range(2):
            ms.mega_stage(0.1, DT, u, unbr, smin, smax, adv._poly,
                          adv._stage_tables)
        sh.stage_ho(0.1, u, unbr, adv._poly, adv._stage_tables)
        wdet = wd.wdet(xs, adv._wdet_tables)
        gc.geom_conv(xs, adv.v_nodes, u, nf._gc_tables, 1.0)
        shn.stage_ho_nodes(xs, adv.v_nodes, u, unbr, tbn, mode=1.0)
        cg.gl_cg(u, wdet, adv._stage_tables)
        gn.gather_nbr(u, adv.shape, adv.periodic,
                      adv.disc.dofmaps.nbr_dof_local)

    seven()
    tr, launches = trc.capture_counted(seven)
    events = trc.check_kernel_events(tr, launches, "test")
    assert events == dict(dict.fromkeys(ops.KERNELS, 1), mega_stage=2)
    rep = trc.loop_report(tr, 1, 1)
    assert rep["kernel_calls"] == 8 and 0.0 <= rep["idle_share"] < 1.0
