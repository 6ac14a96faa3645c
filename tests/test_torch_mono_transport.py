"""Transport with the monolithic RD solver and the smoothness indicator
(`-p 7 -o 1 -mono 1 -si 2`, the CI's `steady-mono2` row) on the CPU.

- The benchmark's entry of the configuration (`driver.build_operator`'s
  operator stepped by `driver.advance`) against its plain reference
  (perfbench/reference/transport_mono.py) at 8^2 and 16^2, float64, on
  three seeds: u after a 2-step phase and the mass of u.
- The maximum principle holds at `mono.bound_preserving_dt`'s step, in
  the program and the reference, stage by stage and over a phase; the
  cell's dt exceeds that step and u leaves its bounds there.
- The indicator's setup tables (`Msub`, `Lop`, `lumped`), formed for all
  elements at once, are bit for bit those of a per-element loop written
  here, on a uniform 8^2 mesh and an uneven 12 x 8 one, at p = 1 and 2.
- The monolithic stage's spans (`remhos.mono` > `remhos.bounds`,
  `remhos.si`, `remhos.lumping`, `remhos.mono_loop`) nest in the stage,
  and neither they nor the counters (`mono_stats["explicit"]`, the
  indicator's `evaluations`) change a bit of the step.
"""

from collections import Counter

import numpy as np
import pytest
import torch

from perfbench import harness
from perfbench import traffic as trf
from perfbench.reference import transport_mono as ref
from remhos_torch import bounds as bnd
from remhos_torch import mono
from remhos_torch import steppers as st
from remhos_torch.config import RunConfig
from remhos_torch.discretization import build_discretization
from remhos_torch.driver import advance, build_operator
from remhos_torch.mesh import make_cartesian_mesh, make_mesh_from_breaks
from remhos_torch.si import SmoothnessIndicator
from remhos_torch.utils import trace as trc
from torch_threads import one_torch_thread  # noqa: F401

F64 = torch.float64
CELL = "transport-mono1-si2-o1.n2048"
SEEDS = (1, 7, 2 ** 31 + 4321)
ENTRY = harness.module_at(harness.HERE / "entries" / "driver_steps_mono.py")


def _cell(n):
    """The cell's configuration and traffic at n^2, dt at the cell's
    Courant number (dt h_cell / h)."""
    cell = harness.Cell(CELL)
    t = dict(cell.traffic)
    t.update(n=n, dt=t["dt"] * t["n"] / n)
    return cell.config, t


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("n", [8, 16])
def test_entry_against_the_reference(n, seed):
    """Tolerances: both sides compute the same float64 sums in other
    orders (the element matrices by other quadrature paths, the vertex
    sums by shifts or a gather), so they part at round-off, carried
    through 6 stages of limiters: measured 3e-16 at 8^2 and 9e-16 at 16^2
    for u, 2e-16 for the mass; 1e-13 and 1e-14 leave a hundredfold room
    and catch any change of the scheme (one flipped limiter moves u by
    ~1e-4). The excess over the inflow bounds is a max of u: the gap of u
    bounds the gap of the excess."""
    config, traffic = _cell(n)
    S0 = trf.initial_fields(ref.points(config, traffic, "cpu"), traffic,
                            seed)
    entry = ENTRY.build(config, traffic, S0, "cpu")
    S, mass = entry.phase()
    judge = ref.Reference(config, traffic, "cpu")
    want = judge.phase(S0)
    assert float((S[0] - want[0]).abs().max()) <= 1e-13
    m_ref = judge.mass(judge.t_end, want[0])
    assert abs(judge.mass(judge.t_end, S[0]) - m_ref) <= 1e-14 * m_ref
    assert abs(mass - m_ref) <= 1e-14 * m_ref
    assert entry.counters() == {"mono_explicit": 6, "si_evaluations": 6}


# ---------------------------------------------------------------------------
# the maximum principle and the step that keeps it
# ---------------------------------------------------------------------------

def _relaxed_bounds(u, xi_min, xi_max, t):
    """[L, U] per dof: the -bt 0 bounds widened by the indicator t toward
    [0, 1] (remhos_mono.cpp's bndN, bndP); L is bndN where u lies in the
    lower half of its bounds, U is bndP in the upper half."""
    bnd_n = (t * (2 * u - xi_max) + (1 - t) * xi_min).clamp(min=0.0)
    bnd_p = (t * (2 * u - xi_min) + (1 - t) * xi_max).clamp(max=1.0)
    return torch.minimum(xi_min, bnd_n), torch.maximum(xi_max, bnd_p)


def _stage(side, entry, judge, u, dt):
    """(u + dt du, L, U) of one forward-Euler stage from u [E, 4], the
    bounds as the side forms them."""
    if side == "program":
        adv = entry.adv
        du = adv.stage_function()(0.0, dt, u[None])[0][0]
        xi_min, xi_max = adv.compute_bounds(*bnd.elements_min_max(u))
        t = adv.smth.dof_values(adv.smth.compute(u))
    else:
        op, g = judge.op, judge.op.g
        du = op.stage(u)
        xi_min = g.element_extrema_at_dofs(u.amin(1), torch.minimum,
                                           float("inf"))
        xi_max = g.element_extrema_at_dofs(u.amax(1), torch.maximum,
                                           -float("inf"))
        t = op.indicator(u)
    return (u + dt * du,) + _relaxed_bounds(u, xi_min, xi_max, t)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("side", ["program", "reference"])
def test_bounds_hold_under_the_bound_preserving_step(side, seed):
    """At 32^2 (the cell's field and Courant number) the cell's dt is about
    20 times `mono.bound_preserving_dt`'s least step. At that step one
    forward-Euler stage keeps every dof off the domain's boundary within
    its bounds, the -bt 0 bounds widened by the indicator (on the boundary
    the inflow lies outside them), from the seeded field and from u after
    a phase at the cell's dt; and a phase keeps u within [0, 1], the
    indicator's outer bounds. At the cell's dt u drops below 0 (by 3.9e-3
    on the first seed). Both sides form their bounds on their own. Round
    off: 1e-14 on values of at most 1."""
    config, traffic = _cell(32)
    pts = ref.points(config, traffic, "cpu")
    S0 = trf.initial_fields(pts, traffic, seed)
    entry = ENTRY.build(config, traffic, S0, "cpu")
    least = float(mono.bound_preserving_dt(
        entry.adv, entry.adv.geometry(0.0)).min())
    assert 19.0 < traffic["dt"] / least < 22.0
    judge = ref.Reference(config, traffic, "cpu")

    def phase(dt):
        if side == "program":
            return advance(entry.step, entry.S0, 0.0, dt, entry.steps)[0][0]
        return judge.op.phase(S0, entry.steps, dt)[0]
    inner = ((pts > 0) & (pts < 1)).all(-1)
    for u in (S0[0], phase(traffic["dt"])):
        u1, lo, hi = _stage(side, entry, judge, u, least)
        assert float((lo - u1)[inner].max()) <= 1e-14
        assert float((u1 - hi)[inner].max()) <= 1e-14
    u = phase(least)
    assert float(u.min()) >= -1e-14 and float(u.max()) <= 1 + 1e-14
    if seed == SEEDS[0]:
        assert float(phase(traffic["dt"]).min()) < -1e-3


# ---------------------------------------------------------------------------
# the indicator's tables against a per-element loop
# ---------------------------------------------------------------------------

def _loop_tables(si_type, disc):
    """(Msub, Lop, lumped) built one element at a time, with the 1D blocks
    h [[1/3, 1/6], [1/6, 1/3]] and (1/h) [[1, -1], [-1, 1]] formed for each
    element on its own."""
    mesh, p, dim = disc.mesh, max(disc.p, 1), disc.dim
    E, nsub = mesh.num_elements, p ** dim
    widths = [np.diff(b) / p for b in mesh.breaks]
    eidx = np.stack(np.unravel_index(np.arange(E), mesh.shape, order="F"),
                    -1)
    hs = np.stack([widths[d][eidx[:, d]] for d in range(dim)], -1)
    Msub = np.empty((E, 2 ** dim, 2 ** dim))
    Lsub = np.empty((E, 2 ** dim, 2 ** dim))
    for e in range(E):
        M1, L1 = np.ones((1, 1)), np.zeros((1, 1))
        for d in range(dim):
            h = hs[e, d]
            m1 = h * np.array([[1 / 3, 1 / 6], [1 / 6, 1 / 3]])
            k1 = (1 / h) * np.array([[1.0, -1.0], [-1.0, 1.0]])
            L1 = np.kron(k1, M1) + np.kron(m1, L1)
            M1 = np.kron(m1, M1)
        Msub[e], Lsub[e] = M1, L1
    Lop = -np.repeat(Lsub[:, None], nsub, axis=1) \
        + SmoothnessIndicator._boundary_face_blocks(mesh, hs, eidx, p, dim)
    si = SmoothnessIndicator(si_type, disc, F64, "cpu")
    corner = si.corner_cg.numpy().reshape(E, -1)
    rows = np.repeat(Msub.sum(axis=2)[:, None, :], nsub, axis=1)
    lumped = np.zeros(si.n_cg)
    for e in range(E):
        for k, node in enumerate(corner[e]):
            lumped[node] += rows[e].reshape(-1)[k]
    return Msub, Lop, lumped


@pytest.mark.parametrize("p", [1, 2])
@pytest.mark.parametrize("mesh", ["8x8", "12x8-uneven"])
def test_indicator_tables_are_the_loops(mesh, p):
    if mesh == "8x8":
        m = make_cartesian_mesh(2, (8, 8), (0.0, 0.0), (1.0, 1.0),
                                (False, False))
    else:
        rng = np.random.default_rng(5)
        breaks = tuple(np.concatenate([[0.0], np.cumsum(rng.uniform(
            0.5, 1.5, k))]) for k in (12, 8))
        m = make_mesh_from_breaks(2, breaks, (False, True))
    disc = build_discretization(m, p)
    si = SmoothnessIndicator(2, disc, F64, "cpu")
    Msub, Lop, lumped = _loop_tables(2, disc)
    assert torch.equal(si.Msub, torch.as_tensor(Msub))
    assert torch.equal(si.Lop, torch.as_tensor(Lop))
    assert torch.equal(si.lumped, torch.as_tensor(lumped))


# ---------------------------------------------------------------------------
# spans and counters
# ---------------------------------------------------------------------------

def _mono_step(problem):
    """One RK3 step of `-o 1 -mono 1 -si 2` on inline-quad at 8^2 from a
    seeded u (problem 7: transport with the inflow, no inner loop; problem
    4: the inner loop too)."""
    cfg = RunConfig(mesh="inline-quad", problem=problem, rs_levels=1,
                    order=1, mono=1, smth_ind=2, dt=0.002, device="cpu",
                    verbose=False)
    adv, _ = build_operator(cfg)
    step = st.make_rk_step(adv.stage_function(), 3)
    g = torch.Generator().manual_seed(3)
    u = torch.rand((64, 4), generator=g, dtype=F64)
    return adv, lambda: step(u[None], 0.0, cfg.dt)[0]


def _parent(spans, child):
    a, b, _, key = child
    holders = [s for s in spans if s[3] == key and s[0] <= a and b <= s[1]
               and s is not child]
    return max(holders, key=lambda s: s[0])[2] if holders else None


@pytest.mark.parametrize("problem", [7, 4])
def test_spans_nest_and_change_nothing(problem):
    adv, step = _mono_step(problem)
    plain = step()
    before = (adv.mono_stats["explicit"], adv.smth.evaluations)
    out = {}
    tr = trc.capture_trace(lambda: out.update(S=step()))
    # two cycles ran under the profiler: 3 stages each
    assert adv.mono_stats["explicit"] - before[0] == 6
    assert adv.smth.evaluations - before[1] == 6
    assert torch.equal(out["S"], plain)
    spans = trc.program_spans(tr)
    names = Counter(n for *_, n, _ in spans)
    assert names["remhos.stage"] == names["remhos.mono"] == 3
    assert names["remhos.si"] == names["remhos.lumping"] == 3
    assert names["remhos.bounds"] == 3
    assert names["remhos.mono_loop"] == (0 if problem == 7 else 3)
    for s in spans:
        if s[2] == "remhos.mono":
            assert _parent(spans, s) == "remhos.stage"
        if s[2] in ("remhos.bounds", "remhos.si", "remhos.lumping",
                    "remhos.mono_loop"):
            assert _parent(spans, s) == "remhos.mono", s
        if s[2] == "remhos.gather":
            assert _parent(spans, s) == "remhos.lumping"
    # off the profiler nothing records, and the step is the same again
    assert torch.equal(step(), plain)
