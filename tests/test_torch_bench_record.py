"""The benchmark record of the port (`remhos_torch.bench.main` and
`tools/sweep.py`) on the CPU at N=4, p=2, 6 steps.

The sizes are cut so that every leg runs in seconds: dt = 0.001 (at the
default 0.2/6 the p=4 leg's closure injection exceeds bench.py's drift
budget on so coarse a mesh). Checked:

- `main`'s record carries bench.py's keys and the port's `kernels` and
  `device`, with `verified` true, at the default leg and at the legs it
  runs alone under one knob each: BENCH_P=4, BENCH_DTYPE=float64 (no
  closure, and the f32-vs-f64 cross check does not apply) and BENCH_N=5;
- the three BENCH_CLOSURE modes verify, and the final state the record
  was taken on is that of bench.py's loop in the same mode on the JAX side
  (tests/torch_jax_bench.py): 2e-3 of max|u| (f32; bf16x3 products on the
  JAX side against true f32 products);
- a skipped cross check leaves `verified` not true;
- BENCH_PALLAS=0 (the plain version on the device) raises ValueError;
  BENCH_POLY_BF16=1 (the bf16 va/vn stream; at dt = 1e-4 here) and
  BENCH_SHARDED=1|2 (the sharded loop in this process, in 2 spawned ranks)
  run and verify;
- BENCH_POLY_BF16=1 at the default dt = 1e-3 is NOT verified: the bf16
  volume/face mismatch injects 1.04e-6 of the mass over 6 steps on this
  4^3 mesh, above the closure's 3.2e-7 budget; the JAX package's loop with
  poly_bf16 on the same inputs injects 8.9e-7 and fails the same budget;
- `tools/sweep.py` runs `python -m remhos_torch.bench` per point with
  bench.py's knobs and writes the sweep record.
"""

import contextlib
import json
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest

from remhos_torch import bench
from remhos_torch.tools import sweep
from torch_jax_bench import jax_loop, jax_run
from torch_threads import one_torch_thread  # noqa: F401

ENV = dict(BENCH_N="4", BENCH_P="2", BENCH_STEPS="6", BENCH_REPS="2",
           BENCH_DT="0.001")
RECORD_KEYS = ("metric", "ndofs", "value", "unit", "vs_baseline",
               "verified", "mass_rel_loss", "mass_closure_injected_rel",
               "f32_vs_f64_2step_rel", "cross_check",
               "hbm_bytes_per_stage_model", "hbm_gb_per_s_model",
               "hbm_util_model", "kernels", "device")
# the keys of BENCH_TRACE and BENCH_PHASES
MEASURE_KEYS = ("kernel_us_per_stage", "glue_us_per_stage",
                "glue_breakdown_us", "idle_share", "fom", "fom_rhs",
                "fom_inv", "fom_lo", "fom_fct", "dispatch_ms_per_call")
# the legs `main` runs under one knob each: (knobs, metric, ndofs)
LEGS = {
    "default": ({}, "fom_total_p2_3d_remap_pa_f32", 64 * 27),
    "p4": (dict(BENCH_P="4"), "fom_total_p4_3d_remap_pa_f32", 64 * 125),
    "float64": (dict(BENCH_DTYPE="float64"), "fom_total_p2_3d_remap_pa_f64",
                64 * 27),
    "n5": (dict(BENCH_N="5"), "fom_total_p2_3d_remap_pa_f32", 125 * 27),
}


def _env(**kw):
    return dict(ENV, **kw)


@pytest.mark.parametrize("leg", LEGS)
def test_main_record(leg):
    """One leg of `main`, verified. The default leg runs the trace and the
    phases and is checked for every key; the others run without them."""
    knob, metric, ndofs = LEGS[leg]
    env = _env(**knob) if leg == "default" else _env(
        BENCH_TRACE="0", BENCH_PHASES="0", **knob)
    rec = bench.main(device="cpu", env=env)
    for key in RECORD_KEYS + (MEASURE_KEYS if leg == "default" else ()):
        assert key in rec, key
    assert rec["metric"] == metric and rec["ndofs"] == ndofs
    assert rec["verified"] is True and rec["value"] > 0
    assert 0 <= rec["mass_rel_loss"] < 1e-6
    assert rec["windows"] == 2 and rec["device"] == "cpu"
    if leg == "float64":
        # no closure in f64, and the f32-vs-f64 cross check does not apply
        assert rec["mass_closure_injected_rel"] is None
        assert rec["cross_check"] == {"status": "skipped",
                                      "reason": "float64 case"}
        assert rec["f32_vs_f64_2step_rel"] is None
    else:
        assert 0 <= rec["mass_closure_injected_rel"] < 1e-6
        assert rec["cross_check"]["status"] == "ran"
        assert 0 < rec["f32_vs_f64_2step_rel"] < 1e-2
    # measured on the CPU: no device rate
    assert rec["hbm_bytes_per_stage_model"] > 0
    assert rec["hbm_gb_per_s_model"] is None
    assert set(rec["kernels"]) == {"mega_stage", "stage_ho", "wdet",
                                   "geom_conv", "stage_ho_nodes", "gl_cg",
                                   "gather_nbr", "fa_assemble", "fa_fct",
                                   "mono_rd"}


@pytest.mark.parametrize("closure", ["full", "0", "1"])
def test_main_closure_modes(closure, tmp_path):
    """Each BENCH_CLOSURE mode verifies, and the final state the record
    was taken on (BENCH_CROSSDUMP) is bench.py's loop's in that mode."""
    dump = tmp_path / "u.npy"
    rec = bench.main(device="cpu", env=_env(BENCH_CLOSURE=closure,
                                            BENCH_TRACE="0",
                                            BENCH_PHASES="0",
                                            BENCH_CROSSDUMP=str(dump)))
    assert rec["verified"] is True
    assert (rec["mass_closure_injected_rel"] is None) == (closure == "0")
    case = bench.build_case(4, 2, device="cpu", n_steps=6, dt=0.001,
                            closure=closure)
    uj, _ = jax_loop(case, 4, 2, jnp.float32, 6, 0.001, closure)
    got = np.load(dump)
    assert got.shape == uj.shape
    assert np.abs(got - uj).max() <= 2e-3 * np.abs(uj).max()


def test_skipped_cross_check_is_not_verified():
    rec = bench.main(device="cpu", env=_env(
        BENCH_CROSSCHECK="0", BENCH_TRACE="0", BENCH_PHASES="0"))
    assert rec["cross_check"]["status"] == "skipped"
    assert rec["verified"] is False and rec["mass_rel_loss"] is not None


@pytest.mark.parametrize("knob", [dict(BENCH_PALLAS="0"),
                                  dict(BENCH_POLY_BF16="1"),
                                  dict(BENCH_SHARDED="1"),
                                  dict(BENCH_SHARDED="2")])
def test_tpu_only_knobs_raise(knob):
    """BENCH_PALLAS=0 is the TPU's alone; the bf16 stream and the sharded
    loop are ported and run (the module docstring)."""
    if "BENCH_PALLAS" in knob:
        with pytest.raises(ValueError, match="ROADMAP"):
            bench.knobs(_env(**knob))
        with pytest.raises(ValueError, match="ROADMAP"):
            bench.main(device="cpu", env=_env(**knob))
        return
    env = _env(BENCH_TRACE="0", BENCH_PHASES="0", **knob)
    if "BENCH_POLY_BF16" in knob:
        env["BENCH_DT"] = "0.0001"
    k = bench.knobs(env)
    assert (k["poly_bf16"], k["sharded"]) == (
        "BENCH_POLY_BF16" in knob, int(knob.get("BENCH_SHARDED", 0)))
    rec = bench.main(device="cpu", env=env)
    assert rec["verified"] is True and rec["mass_rel_loss"] is not None
    if k["sharded"]:
        assert rec["shards"] == k["sharded"]
        assert rec["metric"].endswith(f"_sharded{k['sharded']}")
    else:
        assert rec["poly_bf16"] is True
        assert rec["cross_check"]["status"] == "ran"


def test_poly_bf16_at_the_default_dt_is_not_verified():
    """At this file's default dt (1e-3) the bf16 va/vn stream's
    volume/face mismatch injects ~1e-6 of the mass over 6 steps on the 4^3
    mesh, above the closure's budget (3.2e-7): the record raises instead of
    verifying. The JAX package's bench loop with poly_bf16 on the same
    inputs injects as much and fails the same budget (its witness), while
    both pass it without bf16. `-s` prints the injections."""
    env = _env(BENCH_TRACE="0", BENCH_PHASES="0", BENCH_POLY_BF16="1")
    with pytest.raises(AssertionError, match="absorbed too much") as port:
        bench.main(device="cpu", env=env)
    print(f"port record: {port.value}")
    for bf16 in (True, False):
        case = bench.build_case(4, 2, device="cpu", n_steps=6, dt=0.001,
                                poly_bf16=bf16)
        uT, cT, _, _ = bench.run_steps(case)
        _, _, inj_j = jax_run(case, 4, 2, jnp.float32, 6, 0.001, "1",
                              poly_bf16=bf16)
        check = (pytest.raises(AssertionError, match="absorbed too much")
                 if bf16 else contextlib.nullcontext())
        with check:
            bench.verify(case.adv64, case.u0, uT, 0.001, 6, cT=cT,
                         injected=inj_j, metric32=case.mlk32)
        m0 = float((case.adv64.lumped_mass(0.0) * case.u0_64).sum())
        print(f"JAX loop, poly_bf16={bf16}: injected {inj_j / m0:.3e} "
              "of the mass")


def test_sweep_tool(monkeypatch, tmp_path):
    calls = []

    def fake_run(cmd, env, cwd, capture_output, text):
        calls.append((cmd, env))
        n, p = int(env["BENCH_N"]), int(env["BENCH_P"])
        rec = dict(ndofs=n ** 3 * (p + 1) ** 3, value=float(n * p),
                   verified=True, device="cpu")
        return subprocess.CompletedProcess(cmd, 0, "# x\n" + json.dumps(rec)
                                           + "\n", "")

    monkeypatch.setattr(sweep.subprocess, "run", fake_run)
    out = tmp_path / "sweep.json"
    assert sweep.main([str(out)]) == 0
    assert [c[0][-2:] for c in calls] == [["-m", "remhos_torch.bench"]] * 6
    assert [(c[1]["BENCH_N"], c[1]["BENCH_CROSSCHECK"]) for c in calls] == [
        ("16", "0"), ("24", "1"), ("32", "0"), ("16", "0"), ("24", "0"),
        ("32", "0")]
    assert all(c[1]["BENCH_PHASES"] == "0" for c in calls)
    rec = json.loads(out.read_text())
    assert rec["best"] == {"n": 32, "p": 4, "ndofs": 32 ** 3 * 125,
                           "value": 128.0}
    assert len(rec["points"]) == 6
