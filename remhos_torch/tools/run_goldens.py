"""The golden regression runner of the port: `tools/run_goldens.py` on
remhos_torch (the autotest/test.sh equivalent).

Every row of goldens/reference_goldens.json is handed to
`remhos_torch.driver.run`. A row the port supports runs to its end and its
'Final mass u' and 'Max value u' are held against the reference CI
baseline at the baseline's print precision (10 significant digits: 5e-10
relative), with the JAX runner's per-row tolerances and its `--f32` tier
(which also holds the mass the f32 closure put back to CLOSURE_BUDGET).
A row whose mesh file is absent (the reference's `.mesh` files are not in
the repository; `mesh.find_mesh_file` looks for them by path, then under
$REMHOS_REF_DATA) is listed by name as "needs <name>.mesh, absent",
whatever `--only` and `--skip` select. Any exception and any mismatch of a
row that runs fails the run.

    python -m remhos_torch.tools.run_goldens [--device cpu] [--f32]
        [--only NAME ...] [--skip NAME ...]

The device is the card unless `--device cpu` asks for the CPU. Exit 0 only
if every supported row matches.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

from ..config import RunConfig
from ..driver import run
from ..mesh import find_mesh_file, registry_dim

GOLDENS = Path(__file__).resolve().parents[2] / "goldens" / \
    "reference_goldens.json"
TOL = 5e-10             # the baseline prints 10 significant digits
# the f32 tier's budget for the mass the closure put back, relative to the
# initial mass (chip_smoke.py's closure_injected_rel limit): the closure
# pins the mass, so a loss of the scheme shows here, not in the mass
CLOSURE_BUDGET = 1e-4


def rel_close(a, b, tol):
    return abs(a - b) <= tol * max(abs(a), abs(b), 1e-30)


def check_row(row, r, f32):
    """The mismatch messages of result r against golden row `row` (empty
    when it matches), with tools/run_goldens.py's tolerances."""
    msgs = []
    mass_tol = max(1e-5, 5e-8 * r.steps) if f32 else TOL
    max_tol = TOL
    if f32:
        max_tol = 1e-2 if row["cfg"].get("fct") == 4 else 1e-3
    mass_tol_us = mass_tol
    if f32 and row.get("loss_us"):
        mass_tol_us = max(mass_tol,
                          0.05 * row["loss_us"] / abs(row["mass_us"]))
    if "mass" in row and not rel_close(r.final_mass_u, row["mass"],
                                       mass_tol):
        msgs.append(f"mass {r.final_mass_u:.10g} != {row['mass']:.10g}")
    if "max" in row and not rel_close(r.max_u, row["max"], max_tol):
        msgs.append(f"max {r.max_u:.10g} != {row['max']:.10g}")
    if "mass_us" in row and not rel_close(r.final_mass_us, row["mass_us"],
                                          mass_tol_us):
        msgs.append(f"mass_us {r.final_mass_us:.10g} != "
                    f"{row['mass_us']:.10g}")
    if f32:
        loss_bound = max(1e-5, 5.0 * row.get("loss", 0.0),
                         5.0 * row.get("loss_us", 0.0))
        if r.mass_loss_u > loss_bound:
            msgs.append(f"f32 conservation broken: {r.mass_loss_u:.3g}")
        if r.mass_closure_injected_rel > CLOSURE_BUDGET:
            msgs.append(f"f32 closure injected "
                        f"{r.mass_closure_injected_rel:.3g} of the mass "
                        f"(budget {CLOSURE_BUDGET:g})")
    else:
        if "loss_us" in row and not (
                0.2 * row["loss_us"] <= r.mass_loss_us
                <= 5.0 * row["loss_us"] + 1e-12):
            msgs.append(f"loss_us {r.mass_loss_us:.3g} vs "
                        f"{row['loss_us']:.3g}")
        if "loss" in row and not (0.1 * row["loss"] <= r.mass_loss_u
                                  <= 10.0 * row["loss"] + 1e-12):
            msgs.append(f"loss {r.mass_loss_u:.3g} vs {row['loss']:.3g}")
    return msgs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="remhos_torch.tools.run_goldens")
    ap.add_argument("--only", nargs="*", default=None)
    ap.add_argument("--skip", nargs="*", default=[])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    ap.add_argument("--f32", action="store_true",
                    help="run every row in f32 against the f64 baseline at "
                         "the JAX runner's f32-trajectory tolerances")
    args = ap.parse_args(argv)

    rows = json.loads(GOLDENS.read_text())["runs"]
    matched, failed, absent = [], [], {}
    for row in rows:
        name = row["name"]
        cfg = RunConfig(verbose=False, device=args.device, **row["cfg"],
                        **({"dtype": "float32"} if args.f32 else {}))
        mesh = cfg.mesh
        if (mesh != "default" and registry_dim(mesh) is None
                and find_mesh_file(mesh) is None):
            stem = mesh[:-len(".mesh")] if mesh.endswith(".mesh") else mesh
            absent[name] = f"needs {stem.split('/')[-1]}.mesh, absent"
            print(f"ABSENT     {name:28s} {absent[name]}")
            continue
        if (args.only and name not in args.only) or name in args.skip:
            continue
        t0 = time.perf_counter()
        r = run(cfg)
        msgs = check_row(row, r, args.f32)
        (failed if msgs else matched).append(name)
        inj = (f"closure_injected_rel={r.mass_closure_injected_rel:.3g} "
               if args.f32 else "")
        print(f"{'FAIL' if msgs else 'PASS'} {name:28s} "
              f"mass={r.final_mass_u:.10g} max={r.max_u:.10g} "
              f"steps={r.steps} {inj}[{time.perf_counter() - t0:.1f}s] "
              f"{'; '.join(msgs)}", flush=True)
    print(f"\n{len(matched)} matched, {len(failed)} failed, {len(absent)} "
          "without their mesh file")
    print(json.dumps({"matched": matched, "failed": failed,
                      "absent": absent}))
    return 1 if failed or not matched else 0


if __name__ == "__main__":
    sys.exit(main())
