"""The assembled (FA) remap `-ho 3 -lo 1 -fct 1 -bt 0` against the
benchmark's plain reference of it (perfbench/reference/remap_fa.py), and
the benchmark's entry of that configuration against `driver.run`.

At 4^3, p=2, float64 on the CPU, on seeded random fields:
- the element matrices, one stage's HO, LO and limited rates, and a
  2-step RK3 phase of the program against the reference, to 1e-12 of
  their largest values (measured: 2e-14 for the rates, 7e-15 for the
  phase; the HO solve is a Cholesky in the program and an LU in the
  reference);
- the reference's cross-element d_ij = max(0, -K_HO_ij, -K_HO_ji), which
  it computes over the own-neighbour face blocks, are 0 while those blocks
  are not: the assumption that `fct_flux.py`'s element blocks rest on;
- the entry's phase (`driver.advance` on the program's operator) equals
  `driver.run` over the same two steps bit for bit, state and mass.
"""

import pytest
import torch

from perfbench import harness
from perfbench.reference import remap_fa as ref
from remhos_torch import checkpoint, driver
from remhos_torch import problems as prob
from remhos_torch import steppers as st
from remhos_torch.config import RunConfig
from remhos_torch.discretization import build_discretization
from remhos_torch.mesh import make_cartesian_mesh
from remhos_torch.operator import Advection, SolverConfig
from torch_threads import one_torch_thread  # noqa: F401

F64 = torch.float64
N, P, DT = 4, 2, 0.02
CELL = "remap-fa-ho3lo1fct1-p2.n64"


@pytest.fixture(scope="module")
def setup():
    mesh = make_cartesian_mesh(3, (N,) * 3, (0.0,) * 3, (1.0,) * 3,
                               (False,) * 3)
    disc = build_discretization(mesh, P)
    x0 = torch.as_tensor(mesh.x, dtype=F64)
    v = driver.integrate_mesh_velocity(x0, 10, mesh.bb_min, mesh.bb_max,
                                       0.7, DT)
    cfg = SolverConfig(problem=10, ho=3, lo=1, fct=1, pa=False)
    adv = Advection(disc, cfg, x0, v, dtype=F64, device="cpu")
    sp = ref.Space(N, P)
    assert torch.equal(x0, sp.x0)
    vr = ref.mesh_velocity(sp.x0, DT)
    assert (v - vr).abs().max() < 1e-15
    g = torch.Generator().manual_seed(5)
    u = torch.rand((sp.E, sp.nd), generator=g, dtype=F64)
    return adv, ref.RemapFA(sp, vr), u


def _gap(a, b):
    return float((a - b).abs().max() / b.abs().max())


@pytest.mark.parametrize("t", [0.0, 0.3])
def test_one_stage(setup, t):
    adv, op, u = setup
    geom, g = adv.geometry(t), op.assemble(t)
    for mine, theirs in (("M", "M"), ("K_elem", "K"), ("bdrInt", "B")):
        assert _gap(geom[mine], g[theirs]) < 1e-12, mine
    du_ho = adv.ho_solution(geom, u)
    assert _gap(du_ho, op.ho(g, u)) < 1e-12
    du_lo = adv.lo_solution(geom, u, du_HO=du_ho, dt=DT)
    assert _gap(du_lo, op.lo(g, u)) < 1e-12
    du = adv.stage_function()(t, DT, u[None])[0][0]
    assert _gap(du, op.stage(t, DT, u)) < 1e-12
    assert (du - du_lo).abs().max() > 1e-3 * du.abs().max()   # FCT acted


def test_phase(setup):
    adv, op, u = setup
    step = st.make_rk_step(adv.stage_function(), 3)
    S, _, t, _, _ = driver.advance(step, u[None], 0.0, DT, 2)
    assert t == 2 * DT
    want = op.phase(u[None], 2, DT)
    assert float((S - want).abs().max()) < 1e-12 * float(u.abs().max())
    assert (S - u).abs().max() > 1e-3                        # it moved


def test_cross_element_upwinding_vanishes(setup):
    """Every cross-element entry of K_HO is >= 0 (phi >= 0 pointwise, and
    an upwind face couples only its inflow side), so max(0, -k_ij, -k_ji)
    is 0 there."""
    _, op, _ = setup
    for t in (0.0, 0.5):
        X = op.assemble(t)["X"]
        assert X.min() >= 0.0 and X.max() > 0.0
        assert torch.count_nonzero(op.d_cross(X)) == 0


def test_entry_phase_equals_driver_run(tmp_path):
    """The benchmark's entry at 4^3 (cube01_hex -rs 1, the CI row's mesh)
    from `driver.run`'s own initial field: its phase of two steps is
    `driver.run`'s run to its second step, bit for bit."""
    cell = harness.Cell(CELL)
    traffic = dict(cell.traffic, n=N, dt=DT, steps_per_remap=2)
    kw = dict(mesh="cube01_hex", rs_levels=1, problem=10, order=2, dt=DT,
              t_final=0.7, ho=3, lo=1, fct=1, max_tsteps=2,
              checkpoint_steps=2, checkpoint_path=str(tmp_path / "s.npz"),
              verbose=False, device="cpu")
    res = driver.run(RunConfig(**kw))
    want = torch.as_tensor(checkpoint.load_state(kw["checkpoint_path"])[0])
    mesh = make_cartesian_mesh(3, (N,) * 3, (0.0,) * 3, (1.0,) * 3,
                               (False,) * 3)
    disc = build_discretization(mesh, P)
    u0, _ = driver.project_bernstein(
        torch.as_tensor(mesh.x, dtype=F64), disc.Bm_at_unodes,
        lambda x: prob.u0_function(10, x, mesh.bb_min, mesh.bb_max))
    entry = harness.module_at(harness.HERE / "entries" /
                              "driver_steps_fa.py").build(
        cell.config, traffic, u0[None], "cpu")
    out = entry.phase()
    assert torch.equal(entry.state(out), want)
    assert out[1] == res.final_mass_u
