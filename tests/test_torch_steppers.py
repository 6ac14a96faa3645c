"""The time integrators of remhos_torch against remhos_tpu on the CPU.

- `construct_d` and the tableaus: equal to 1e-15 (the same host floats).
- The IDP-RK steppers (kinds 11, 12, 13, 14, 16), with and without the
  stage masks, and the tableau RK6, on a small two-field operator (2D 6x4,
  p=3, product remap with partly empty elements, so the masks are neither
  all true nor all false): two steps (one for RK6, see there), the final
  state <= 1e-10 * max|S| in f64, the aux dt ratio <= 1e-9 relative and its violation count equal. The
  JAX operator is `Advection(use_pallas=True)` with its Pallas kernels in
  interpret mode; the port's runs the plain versions of its CUDA kernels.
- The aux channel through `make_rk_step`: the minimum over the stages, and
  None when every stage gives None.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from remhos_tpu import steppers as jst
from remhos_tpu.discretization import build_discretization as jbuild
from remhos_tpu.mesh import make_cartesian_mesh as jmesh
from remhos_tpu.operator import Advection as JAdvection
from remhos_tpu.operator import SolverConfig as JConfig

from remhos_torch import steppers
from remhos_torch.discretization import build_discretization
from remhos_torch.mesh import make_cartesian_mesh
from remhos_torch.operator import Advection, SolverConfig

SHAPE, P, T0, DT, STEPS = (6, 4), 3, 0.1, 0.004, 2


@pytest.mark.parametrize("kind", [12, 13, 14, 16])
def test_construct_d_and_tableaus(kind):
    tj, tt = jst.IDP_TABLEAUS[kind], steppers.IDP_TABLEAUS[kind]
    assert tj == tt
    dj = jst.construct_d(tj["a"], tj["b"], tj["c"], tj["s"])
    dt_ = steppers.construct_d(tt["a"], tt["b"], tt["c"], tt["s"])
    np.testing.assert_allclose(dt_, dj, rtol=0, atol=1e-15)
    assert all(isinstance(v, float) for v in
               [float(x) for x in dt_])      # host floats: no f32 promotion


def test_rk6_tableau_equal():
    assert steppers.RK6_BUTCHER == jst.RK6_BUTCHER


def _operators(kind, use_masks=False):
    args = (2, SHAPE, (0.0, 0.0), (1.0, 1.0), (False, False))
    jd = jbuild(jmesh(*args), P)
    td = build_discretization(make_cartesian_mesh(*args), P)
    x0 = jd.mesh.x
    v = 0.1 * np.sin(x0)
    kw = dict(problem=10, ho=3, lo=5, fct=2, pa=True, product_sync=True,
              dt_control=1, verify_bounds=True, ode_solver=kind,
              use_masks=use_masks)
    jadv = JAdvection(jd, JConfig(use_pallas=True, **kw), jnp.asarray(x0),
                      jnp.asarray(v), None)
    adv = Advection(td, SolverConfig(**kw), x0, v, dtype=torch.float64,
                    device="cpu")
    rng = np.random.default_rng(5)
    E, nd = jd.mesh.num_elements, jd.nd
    u = rng.random((E, nd))
    u[rng.random(E) < 0.3] = 0.0                       # empty elements
    part = (rng.random(E) < 0.3)[:, None] & (rng.random((E, nd)) < 0.5)
    u[part] = 0.0                                      # partly empty ones
    S = np.stack([u, u * (2.0 + rng.random((E, nd)))])
    return jadv, adv, S


def _compare(step_j, step_t, S, steps=STEPS):
    Sj, St = jnp.asarray(S), torch.tensor(S)
    t = T0
    for _ in range(steps):
        Sj, auxj = step_j(Sj, t, DT)
        St, auxt = step_t(St, t, DT)
        rj, rt = float(auxj[0]), float(auxt[0])
        assert abs(rt - rj) <= 1e-9 * abs(rj)
        assert float(auxt[1]) == float(auxj[1])
        t += DT
    Sj = np.asarray(Sj)
    assert St.dtype == torch.float64
    assert np.abs(St.numpy() - Sj).max() <= 1e-10 * np.abs(Sj).max()


@pytest.mark.parametrize("kind", [11, 12, 13, 14, 16])
@pytest.mark.parametrize("use_masks", [False, True])
def test_idp_steps_match_jax(kind, use_masks):
    jadv, adv, S = _operators(kind, use_masks)
    mask = adv.compute_mask(torch.tensor(S))
    assert mask.any() and not mask.all()
    step_j = jst.make_idp_step(
        jadv.mult_unlimited, jadv.limit_mult, kind,
        compute_mask=jadv.compute_mask, use_masks=use_masks,
        geometry=jadv.geometry)
    step_t = steppers.make_idp_step(
        adv.mult_unlimited, adv.limit_mult, kind,
        compute_mask=adv.compute_mask, use_masks=use_masks,
        geometry=adv.geometry)
    _compare(step_j, step_t, S)


def test_idp_without_geometry_cache():
    """geometry=None: the plain 3- and 4-argument calls of both halves."""
    jadv, adv, S = _operators(12)
    _compare(jst.make_idp_step(jadv.mult_unlimited, jadv.limit_mult, 12),
             steppers.make_idp_step(adv.mult_unlimited, adv.limit_mult, 12),
             S)


@pytest.mark.parametrize("kind,compensated", [(6, False), (6, True),
                                              (3, False), (4, True)])
def test_rk_steps_with_aux_match_jax(kind, compensated):
    """Standard and tableau RK on the two-field operator, with the aux
    channel combined over the stages."""
    jadv, adv, S = _operators(kind)
    step_j = jst.make_rk_step(jadv.stage_function(), kind,
                              compensated=compensated)
    step_t = steppers.make_rk_step(adv.stage_function(), kind,
                                   compensated=compensated)
    if not compensated:
        # RK6 is held over one step: its tableau has entries of +-200 that
        # cancel, which multiply the two sides' last-digit differences by
        # ~100 a step (1e-12 after one step, 1e-10 after two; RK4 stays at
        # 1e-15)
        return _compare(step_j, step_t, S, steps=1 if kind == 6 else STEPS)
    Sj, St = jnp.asarray(S), torch.tensor(S)
    Cj, Ct = jnp.zeros_like(Sj), torch.zeros_like(St)
    Sj, Cj, auxj = step_j(Sj, Cj, T0, DT)
    St, Ct, auxt = step_t(St, Ct, T0, DT)
    assert abs(float(auxt[0]) - float(auxj[0])) <= 1e-9 * abs(float(auxj[0]))
    assert float(auxt[1]) == float(auxj[1])
    tot_j = np.asarray(Sj) + np.asarray(Cj)
    assert np.abs((St + Ct).numpy() - tot_j).max() <= \
        1e-10 * np.abs(tot_j).max()


def test_idp_rejects_bad_arguments():
    with pytest.raises(ValueError, match="compute_mask"):
        steppers.make_idp_step(None, None, 12, use_masks=True)
    with pytest.raises(ValueError, match="IDP"):
        steppers.make_idp_step(None, None, 15)
    with pytest.raises(ValueError, match="RK type"):
        steppers.make_rk_step(None, 5)


@pytest.mark.parametrize("kind", [1, 2, 3, 4, 6])
def test_aux_is_min_over_stages(kind):
    """aux = elementwise minimum over the stages; a stage that returns None
    is skipped; all None gives None (no combine is launched)."""
    calls = []

    def f(t, dt, u):
        calls.append(t)
        n = len(calls)
        aux = None if n == 2 else torch.tensor([10.0 - n, -float(n % 3)])
        return -u, aux

    u = torch.ones(3, dtype=torch.float64)
    _, aux = steppers.make_rk_step(f, kind)(u, 0.0, 0.1)
    n = len(calls)
    assert n == {1: 1, 2: 2, 3: 3, 4: 4, 6: 8}[kind]
    used = [k for k in range(1, n + 1) if k != 2]
    assert aux.tolist() == [10.0 - max(used), min(-float(k % 3)
                                                  for k in used)]
    _, none = steppers.make_rk_step(lambda t, dt, x: (-x, None), kind)(
        u, 0.0, 0.1)
    assert none is None
    assert steppers.min_aux(None, None) is None
