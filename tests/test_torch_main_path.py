"""The whole slice of remhos_torch against remhos_tpu on the CPU, and the
port's guards.

The slice is bench.py's main path at a small size: 4 RK3 steps with the
Kahan-compensated combine and, in f32, each BENCH_CLOSURE mode (the
incremental mass closure every step and the full f64 closure at the end;
the full closure every step; none), or the compensated combine alone
(f64). The JAX loop (tests/torch_jax_bench.py) is built from
remhos_tpu.steppers and Advection with the Pallas mega kernel in interpret
mode, as bench.make_loop builds it.
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

import jax.numpy as jnp

from remhos_tpu import steppers as jst

from remhos_torch import bench
from torch_jax_bench import jax_loop
from torch_threads import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
SHAPE_N, STEPS = 3, 4
DT = 0.2 / 320


def _hold_slice(dtype, tol, closure):
    case = bench.build_case(n=SHAPE_N, order=3, dtype=dtype, device="cpu",
                            n_steps=STEPS, dt=DT, closure=closure)
    uT, cT, injected, t = bench.run_steps(case)
    assert t == pytest.approx(STEPS * DT, rel=1e-15)
    closed = case.closure is not None
    assert closed == (dtype == torch.float32 and closure != "0")
    rel_loss, inj = bench.verify(
        case.adv64, case.u0, uT, DT, STEPS, cT=cT,
        injected=injected if closed else None,
        metric32=case.mlk32)
    if closed or dtype == torch.float64:
        # without a closure, f32 drifts within verify's own budget
        assert rel_loss < 1e-8
    assert (inj is not None) == closed
    uj, cj = jax_loop(case, SHAPE_N, 3, {torch.float64: jnp.float64,
                                         torch.float32: jnp.float32}[dtype],
                      STEPS, DT, closure)
    scale = np.abs(uj).max()
    assert np.abs(uT.double().numpy() - uj).max() <= tol * scale
    # the closed states (u + c) agree to the same tolerance
    closed = (uT.double() + cT.double()).numpy()
    assert np.abs(closed - (uj + cj)).max() <= tol * scale


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-10),
                                       (torch.float32, 2e-3)])
def test_slice_matches_jax_loop(dtype, tol):
    """BENCH_CLOSURE=1: the incremental closure, then the re-anchor."""
    _hold_slice(dtype, tol, "1")


@pytest.mark.parametrize("closure", ["full", "0"])
def test_slice_closure_modes_match_jax_loop(closure):
    """BENCH_CLOSURE=full (the f64 closure every step, no re-anchor) and
    BENCH_CLOSURE=0 (the compensated combine alone) in f32."""
    _hold_slice(torch.float32, 2e-3, closure)


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
            "remhos_torch.tools.microbench, remhos_torch.tools.kernelbench, "
            "remhos_torch.tools.kernel_variants, remhos_torch.cli, "
            "remhos_torch.checkpoint, remhos_torch.models, "
            "remhos_torch.tools.run_goldens, remhos_torch.tools.sweep, "
            "remhos_torch.tools.trace_drops, remhos_torch.ho, "
            "remhos_torch.fct_flux, remhos_torch.fct_penalty, "
            "remhos_torch.bounds, remhos_torch.dofmaps, "
            "remhos_torch.mono, remhos_torch.si; "
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
    """Nothing of the solvers is left unported: the configurations that
    raised NotImplementedError for the bf16 P16 stream (poly_bf16) until
    PR 13 now build (with P16 where the f32 fused stage streams it) or
    raise ValueError where the JAX package rejects the solvers."""
    from remhos_torch.operator import (Advection, SolverConfig,
                                       solver_rejected)
    case = bench.build_case(n=2, order=3, device="cpu", n_steps=2)
    for cfg in (SolverConfig(problem=4, fct=3, smth_ind=1, poly_bf16=True),
                SolverConfig(lo=1, mono=1, poly_bf16=True),
                SolverConfig(fct=1, mono=2, poly_bf16=True),
                SolverConfig(ho=1, smth_ind=2, poly_bf16=True),
                SolverConfig(mono=1, poly_bf16=True),
                SolverConfig(smth_ind=1, poly_bf16=True),
                SolverConfig(poly_bf16=True),
                SolverConfig(bounds_type=1, poly_bf16=True),
                SolverConfig(pa=False, mono=1, poly_bf16=True)):
        if solver_rejected(cfg) is not None:
            with pytest.raises(ValueError):
                Advection(case.disc, cfg, case.adv.x0_nodes,
                          case.adv.v_nodes, device="cpu")
            continue
        adv = Advection(case.disc, cfg, case.adv.x0_nodes, case.adv.v_nodes,
                        device="cpu")
        assert adv._fused_stage == (adv._poly16 is not None)
    # what the JAX package rejects raises ValueError
    for cfg in (SolverConfig(lo=1), SolverConfig(fct=1),
                SolverConfig(ho=1), SolverConfig(ho=0),
                SolverConfig(mono=1)):
        with pytest.raises(ValueError):
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
