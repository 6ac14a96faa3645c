"""At 4^3 on the CPU the float64 reference agrees with the program's plain
path (its kernels' plain PyTorch versions) for both configurations."""

import pytest
import torch

from perfbench import traffic as trf
from perfbench.reference import remap as ref

F64 = torch.float64
N, P, DT, STEPS = 4, 3, 5e-3, 3
TRAFFIC = dict(bumps=[[0.3, 1.0]], boxes=[[0.15, 0.8]], margin=0.3)


@pytest.fixture(scope="module")
def setup():
    from remhos_torch.discretization import build_discretization
    from remhos_torch.driver import integrate_mesh_velocity
    from remhos_torch.mesh import make_cartesian_mesh
    mesh = make_cartesian_mesh(3, (N,) * 3, (0.0,) * 3, (1.0,) * 3,
                               (False,) * 3)
    disc = build_discretization(mesh, P)
    x0 = torch.as_tensor(mesh.x, dtype=F64)
    v = integrate_mesh_velocity(x0, 10, mesh.bb_min, mesh.bb_max, 0.7,
                                6.25e-4)
    sp = ref.Space(N, P)
    return disc, x0, v, sp, ref.mesh_velocity(sp.x0, 6.25e-4)


def test_mesh_and_velocity(setup):
    _, x0, v, sp, vr = setup
    assert torch.equal(x0, sp.x0)
    assert (v - vr).abs().max() < 1e-15


def _program(disc, x0, v, lo, product):
    from remhos_torch.operator import Advection, SolverConfig
    cfg = SolverConfig(problem=10, ho=3, lo=lo, fct=2, pa=True,
                       product_sync=product)
    return Advection(disc, cfg, x0, v, dtype=F64, device="cpu")


@pytest.mark.parametrize("lo,product", [(5, False), (3, True)])
def test_one_stage(setup, lo, product):
    """One stage's rates to round-off of their largest (1e-10 with the
    product field: s = us / u on the nearly empty dofs amplifies it)."""
    disc, x0, v, sp, vr = setup
    S0 = trf.initial_fields(sp.bernstein_points(), TRAFFIC, 7, product)
    adv = _program(disc, x0, v, lo, product)
    op = ref.Remap(sp, vr, lo, product)
    for t in (0.0, 0.3):
        got = adv.stage_function()(t, DT, S0)[0]
        gap = (got - op.stage(t, DT, S0)).abs().max()
        assert gap < (1e-10 if product else 1e-12) * got.abs().max()


@pytest.mark.parametrize("lo,product", [(5, False), (3, True)])
def test_phase(setup, lo, product):
    """The program's Kahan RK3 loop with the full closure against the
    reference's phase: u to round-off; us, whose dofs at the material's
    edge are ill-conditioned (s = us / u: the program's closure shift
    reaches its stages a step later than the reference's, and that alone
    moves us there), by its mass."""
    from remhos_torch import steppers as st
    from remhos_torch.geometry import lumped_mass_poly
    disc, x0, v, sp, vr = setup
    S0 = trf.initial_fields(sp.bernstein_points(), TRAFFIC, 7, product)
    adv = _program(disc, x0, v, lo, product)
    step = st.make_rk_step(adv.stage_function(), 3, compensated=True)
    mlk, sig = lumped_mass_poly(x0, v, disc)
    close = st.make_mass_closure(mlk, sig.numpy(),
                                 float(mlk[0].reshape(-1) @ S0[0].reshape(-1)))
    S, C, t = S0, torch.zeros_like(S0), 0.0
    for _ in range(STEPS):
        S, C, _ = step(S, C, t, DT)
        t += DT
        C[0] = close(S[0], C[0], t)[0]
    got = S + C
    op = ref.Remap(sp, vr, lo, product)
    want = op.phase(S0, STEPS, DT)
    assert (got[0] - want[0]).abs().max() < 1e-12
    assert (got[0] - S0[0]).abs().max() > 1e-3          # it moved
    if product:
        ml = op.geometry(t)["ml"]
        mass = [(ml * x[1]).sum() for x in (got, want)]
        assert abs(mass[0] - mass[1]) < 1e-8 * abs(mass[1])


def test_overlap_bounds_against_a_loop(setup):
    """Each dof's bound is the extremum over the elements that share its
    Gauss-Lobatto node, checked element by element."""
    sp = setup[3]
    op = ref.Remap(sp, setup[4], 5)
    g = torch.Generator().manual_seed(3)
    el = torch.rand(sp.E, generator=g, dtype=F64)
    lo, hi = op.overlap_bounds(el, el)
    n = sp.n
    for e in (0, 5, 21, 42, 63):
        ix, iy, iz = e % n, (e // n) % n, e // n ** 2
        for j, cls in enumerate(sp.dof_class):
            rng = [range(max(i - (c == 0), 0), min(i + (c == 2), n - 1) + 1)
                   for i, c in zip((ix, iy, iz), cls)]
            vals = [el[a + n * b + n * n * c] for a in rng[0] for b in rng[1]
                    for c in rng[2]]
            assert lo[e, j] == min(vals) and hi[e, j] == max(vals)


def test_the_tf32_rounding():
    x = torch.tensor([1.0 + 2.0 ** -11, 1.0 + 3 * 2.0 ** -11, 1.0 + 2 ** -10])
    assert ref._tf32(x).tolist() == [1.0, 1.0 + 2 ** -9, 1.0 + 2 ** -10]
