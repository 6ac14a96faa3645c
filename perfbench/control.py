"""The readings that the limits of `correct` are set from; the benchmark's
own runs do not run this.

    python3 perfbench/control.py --workload <cell> --seeds 1-12 \
        --control-seeds 1-3 [--poly-bf16]

In one process on the chip, at the cell's own size: for each of --seeds,
the program's phase from that seed's fields (two phases, the worse kept)
against the float64 reference, every number the cell compares ("program":
the lower readings); for each of --control-seeds the control, the
reference itself computed in float32 with TF32 products ("tf32": the upper
readings), and the reference in plain float32 beside it ("float32"). With
--poly-bf16 the program's own bf16 geometry stream (its `poly_bf16`
option) is read as well ("poly_bf16"). One JSON line per reading.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import copy  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

from perfbench import harness  # noqa: E402
from perfbench import traffic as trf  # noqa: E402


def seed_list(text):
    """"1-12" or "1,5,9" -> [ints]."""
    if "-" in text:
        a, b = text.split("-")
        return list(range(int(a), int(b) + 1))
    return [int(s) for s in text.split(",")]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="1-12")
    ap.add_argument("--control-seeds", default="1-3")
    ap.add_argument("--poly-bf16", action="store_true")
    args = ap.parse_args(argv)
    dev = "cuda"
    cell = harness.Cell(args.workload)
    c, t = cell.config, cell.traffic
    product = c["solver"]["product_sync"]
    refmod = cell.reference()
    pts = refmod.points(c, t, dev)
    judge = refmod.Reference(c, t, dev)
    checks = {k: harness.module_at(harness.HERE / "checks" / f"{k}.py").value
              for k in cell.cell["limits"]}
    build = harness.module_at(harness.HERE / "entries"
                              / f"{c['entry']}.py").build

    def fields(seed):
        return trf.initial_fields(pts, t, seed, product)

    def emit(kind, seed, S0, states, want, **extra):
        vals = {k: max(fn(s, S0, want, judge) for s in states)
                for k, fn in checks.items()}
        print(json.dumps(dict(kind=kind, workload=args.workload, seed=seed,
                              **vals, **extra)), flush=True)

    entries = {"program": build(c, t, fields(1), dev)}
    if args.poly_bf16:
        c16 = copy.deepcopy(c)
        c16["solver"]["poly_bf16"] = True
        entries["poly_bf16"] = build(c16, t, fields(1), dev)
    print(json.dumps(dict(setup_s=time.perf_counter() - T_START,
                          device=torch.cuda.get_device_name())), flush=True)
    for seed in seed_list(args.seeds):
        S0 = fields(seed)
        t0 = time.perf_counter()
        want = judge.phase(S0)
        float(want.sum())
        ref_s = time.perf_counter() - t0
        # the reference's own guarantees: bounds and the mass of u
        ref_vals = {f"reference_{k}": checks[k](want, S0, want, judge)
                    for k in ("u_bounds_excess", "u_mass_gap")
                    if k in checks}
        for kind, entry in entries.items():
            entry.load(S0)
            states = [entry.state(entry.phase()) for _ in range(2)]
            emit(kind, seed, S0, states, want, reference_s=ref_s,
                 **ref_vals)
    for seed in seed_list(args.control_seeds):
        S0 = fields(seed)
        want = judge.phase(S0)
        for kind, tf32 in (("tf32", True), ("float32", False)):
            low = refmod.Reference(c, t, dev, dtype=torch.float32, tf32=tf32)
            emit(kind, seed, S0, [low.phase(S0).double()], want)
            del low
    return 0


if __name__ == "__main__":
    sys.exit(main())
