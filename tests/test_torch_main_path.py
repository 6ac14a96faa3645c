"""The whole slice of remhos_torch against remhos_tpu on the CPU, and the
port's guards.

The slice is bench.py's main path at a small size: 4 RK3 steps with the
Kahan-compensated combine, the incremental mass closure every step and the
full f64 closure at the end (f32), or the compensated combine alone (f64).
The JAX loop is built from remhos_tpu.steppers and Advection with the
Pallas mega kernel in interpret mode, as bench.make_loop builds it.
Tolerances on the final state: <= 1e-10 * max|u| in f64 and <= 2e-3 *
max|u| in f32 (bf16x3 products on the JAX side against true f32 products).
"""

import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from remhos_tpu import geometry as jgeo
from remhos_tpu import steppers as jst
from remhos_tpu.operator import Advection as JAdvection
from remhos_tpu.operator import SolverConfig as JConfig

from remhos_torch import bench

ROOT = Path(__file__).resolve().parents[1]
SHAPE_N, STEPS = 3, 4
DT = 0.2 / 320


def _jax_loop(case, jdt):
    """bench.make_loop's body for `case`'s inputs, on the JAX side."""
    disc = _jax_disc()
    x0 = jnp.asarray(case.adv64.x0_nodes.numpy())
    v = jnp.asarray(case.adv64.v_nodes.numpy())
    u0 = jnp.asarray(case.u0_64.numpy())
    cfg = JConfig(problem=10, ho=3, lo=5, fct=2, ode_solver=3, pa=True,
                  use_pallas=True)
    closure = closure_inc = None
    if jdt == jnp.float32:
        mlk, sig = jgeo.lumped_mass_poly(x0, v, disc)
        mlk32 = mlk.astype(jdt)
        sig = np.asarray(sig)
        x0, v, u0 = x0.astype(jdt), v.astype(jdt), u0.astype(jdt)
        m0 = float(mlk32[0].astype(jnp.float64).reshape(-1)
                   @ u0.astype(jnp.float64).reshape(-1))
        closure = jst.make_mass_closure(mlk32, sig, m0)
        closure_inc = jst.make_mass_closure_inc(mlk32, sig)
    adv = JAdvection(disc, cfg, x0, v, None, dtype=jdt)
    assert adv._mega_stage_eligible()
    step = jax.jit(jst.make_rk_step(adv.stage_function(), 3,
                                    compensated=True,
                                    with_delta=closure_inc is not None),
                   static_argnums=3)
    S, C = jnp.stack([u0]), jnp.zeros((1,) + u0.shape, jdt)
    t = jnp.asarray(0.0, jnp.float64)
    coefs = (closure_inc.coefs(DT, STEPS) if closure_inc is not None
             else None)
    for i in range(STEPS):
        t_new = t + DT
        if closure_inc is not None:
            S, C, _, delta = step(S, C, t.astype(jdt), DT)
            c_u, _ = closure_inc(S[0], C[0], delta[0], t, t_new,
                                 coefs=tuple(jnp.asarray(a[i])
                                             for a in coefs))
            C = C.at[0].set(c_u)
        else:
            S, C, _ = step(S, C, t.astype(jdt), DT)
        t = t_new
    if closure is not None:
        c_u, _ = closure(S[0], C[0], t)
        C = C.at[0].set(c_u)
    return np.asarray(S[0], np.float64), np.asarray(C[0], np.float64)


def _jax_disc():
    from remhos_tpu.discretization import build_discretization
    from remhos_tpu.mesh import make_cartesian_mesh
    m = make_cartesian_mesh(3, (SHAPE_N,) * 3, (0, 0, 0), (1, 1, 1),
                            (False,) * 3)
    return build_discretization(m, 3)


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-10),
                                       (torch.float32, 2e-3)])
def test_slice_matches_jax_loop(dtype, tol):
    case = bench.build_case(n=SHAPE_N, order=3, dtype=dtype, device="cpu",
                            n_steps=STEPS, dt=DT)
    uT, cT, injected, t = bench.run_steps(case)
    assert t == pytest.approx(STEPS * DT, rel=1e-15)
    rel_loss, inj = bench.verify(
        case.adv64, case.u0, uT, DT, STEPS, cT=cT,
        injected=injected if case.closure is not None else None,
        metric32=case.mlk32)
    assert rel_loss < 1e-8
    assert (inj is not None) == (dtype == torch.float32)
    uj, cj = _jax_loop(case, {torch.float64: jnp.float64,
                              torch.float32: jnp.float32}[dtype])
    scale = np.abs(uj).max()
    assert np.abs(uT.double().numpy() - uj).max() <= tol * scale
    # the closed states (u + c) agree to the same tolerance
    closed = (uT.double() + cT.double()).numpy()
    assert np.abs(closed - (uj + cj)).max() <= tol * scale


def test_bench_run_records_skipped_cross_check():
    """A float64 case holds no f32 state to check: the record says the
    cross check was skipped, and verify still ran."""
    case = bench.build_case(n=2, order=3, dtype=torch.float64, device="cpu",
                            n_steps=2, dt=DT)
    rec = bench.run(case)
    assert rec["cross_check"] == {"status": "skipped",
                                  "reason": "float64 case"}
    assert rec["verified"] and rec["ndofs"] == 8 * 64


def test_bench_run_cross_check_runs_for_f32():
    case = bench.build_case(n=2, order=3, dtype=torch.float32, device="cpu",
                            n_steps=2, dt=DT)
    rec = bench.run(case)
    assert rec["cross_check"]["status"] == "ran"
    assert rec["cross_check"]["f32_vs_f64_2step_rel"] < 1e-2
    assert rec["mass_closure_injected_rel"] is not None


def test_import_pulls_in_no_jax():
    code = ("import sys, remhos_torch, remhos_torch.bench, "
            "remhos_torch.convert, remhos_torch.driver, "
            "remhos_torch.config, remhos_torch.ops.stage_ho, "
            "remhos_torch.ops.wdet, remhos_torch.ops.build, "
            "remhos_torch.ops.geom_conv, remhos_torch.assembly, "
            "remhos_torch.subcell, remhos_torch.pa, remhos_torch.lo, "
            "remhos_torch.ops.stage_ho_nodes, remhos_torch.ops.gl_cg, "
            "remhos_torch.ops.gather_nbr, remhos_torch.utils.cost, "
            "remhos_torch.utils.trace, remhos_torch.utils.fom, "
            "remhos_torch.tools.microbench, remhos_torch.tools.kernelbench; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m.startswith('remhos_tpu')]; "
            "assert not bad, bad")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   cwd=str(ROOT), timeout=120)


def test_sources_import_no_jax():
    """No source of the port (nor chip_smoke.py) imports jax or remhos_tpu,
    by statement or by name. (They cite remhos_tpu files in prose.)"""
    pat = re.compile(r"^\s*(?:import|from)\s+(?:jax|remhos_tpu)\b"
                     r"|(?:import_module|__import__)\(\s*[\"'](?:jax|remhos_tpu)",
                     re.M)
    files = list((ROOT / "remhos_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 20
    for f in files:
        hits = pat.findall(f.read_text())
        assert not hits, (f, hits)


def test_entry_points_default_to_cuda():
    """device=None means CUDA; without CUDA the entry points raise rather
    than run on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        bench.build_case(n=2, order=3)
    from remhos_torch.operator import Advection, SolverConfig
    case = bench.build_case(n=2, order=3, device="cpu", n_steps=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        Advection(case.disc, SolverConfig(), case.adv.x0_nodes,
                  case.adv.v_nodes)


def test_unported_configurations_raise():
    from remhos_torch.operator import Advection, SolverConfig
    case = bench.build_case(n=2, order=3, device="cpu", n_steps=2)
    for cfg in (SolverConfig(problem=4), SolverConfig(lo=1),
                SolverConfig(fct=1), SolverConfig(ho=1),
                SolverConfig(mono=1), SolverConfig(smth_ind=1),
                SolverConfig(poly_bf16=True),
                SolverConfig(bounds_type=1), SolverConfig(pa=False)):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            Advection(case.disc, cfg, case.adv.x0_nodes, case.adv.v_nodes,
                      device="cpu")


@pytest.mark.parametrize("kind", [1, 2, 3, 4])
def test_rk_steps_match_jax(kind):
    """make_rk_step, plain and compensated, on an analytic f64 stage
    function: same arithmetic as the JAX steppers up to op order."""
    from remhos_torch import steppers
    rng = np.random.default_rng(kind)
    u = rng.standard_normal((5, 8))
    c = 1e-17 * rng.standard_normal((5, 8))

    def fj(t, dt, x):
        return -(1.0 + t) * x + 0.1 * jnp.sin(x), jnp.asarray(jnp.inf)

    def ft(t, dt, x):
        return -(1.0 + t) * x + 0.1 * torch.sin(x), None

    t0, dt = 0.3, 0.05
    pj = jst.make_rk_step(fj, kind)(jnp.asarray(u), t0, dt)[0]
    pt, aux = steppers.make_rk_step(ft, kind)(torch.tensor(u), t0, dt)
    assert aux is None          # every stage's aux was None: no combine
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=0,
                               atol=1e-14)
    uj, cj, _, dj = jst.make_rk_step(fj, kind, compensated=True,
                                     with_delta=True)(
        jnp.asarray(u), jnp.asarray(c), t0, dt)
    ut, ct, _, dtt = steppers.make_rk_step(ft, kind, compensated=True,
                                           with_delta=True)(
        torch.tensor(u), torch.tensor(c), t0, dt)
    for a, b in ((ut, uj), (ct, cj), (dtt, dj)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-14)


def test_mass_closures_match_jax():
    """Full and incremental closures on the same f64 inputs: deficits and
    compensation shifts agree to f64 round-off."""
    from remhos_torch import steppers
    rng = np.random.default_rng(9)
    K, E, nd = 4, 6, 8
    mlk = rng.random((K, E, nd)) * np.array([1.0, 0.1, 0.01, 0.001])[
        :, None, None]
    sig = mlk.sum(axis=(1, 2))
    u, c, d = (rng.random((E, nd)) for _ in range(3))
    m0 = 1.2345
    cj, defj = jst.make_mass_closure(jnp.asarray(mlk), sig, m0)(
        jnp.asarray(u), jnp.asarray(c), 0.37)
    ct, deft = steppers.make_mass_closure(torch.tensor(mlk), sig, m0)(
        torch.tensor(u), torch.tensor(c), 0.37)
    assert abs(float(deft) - float(defj)) <= 1e-14 * abs(float(defj))
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), rtol=0,
                               atol=1e-14 * np.abs(np.asarray(cj)).max())
    inc_j = jst.make_mass_closure_inc(jnp.asarray(mlk), sig)
    inc_t = steppers.make_mass_closure_inc(torch.tensor(mlk))
    coefs = steppers.closure_coefs(sig, 0.01, 3)
    for a, b in zip(coefs, jst.closure_coefs(sig, 0.01, 3)):
        np.testing.assert_array_equal(a, b)
    for i in (0, 2):
        # the JAX side works out t^k itself from t0, t1; the port takes
        # them from closure_coefs, as its step loop does
        cj, defj = inc_j(jnp.asarray(u), jnp.asarray(c), jnp.asarray(d),
                         0.01 * i, 0.01 * (i + 1))
        ct, deft = inc_t(torch.tensor(u), torch.tensor(c), torch.tensor(d),
                         tuple(torch.tensor(a[i]) for a in coefs))
        assert abs(float(deft) - float(defj)) <= 1e-13 * abs(float(defj))
        np.testing.assert_allclose(ct.numpy(), np.asarray(cj), rtol=0,
                                   atol=1e-13 * np.abs(np.asarray(cj)).max())
