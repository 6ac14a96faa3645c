"""Size and order sweep of the benchmark record: the port of tools/sweep.py.

Runs `python -m remhos_torch.bench` once per (N, p) point of GRID, each in
a subprocess with this process's environment plus the point's knobs (f32,
mass and bounds verified; the f32-vs-f64 cross check at the headline point
only, so the other points record it as skipped and are not `verified`),
collects each point's JSON line and writes one sweep record with the best
point and the smallest size within 10% of it.

    python -m remhos_torch.tools.sweep [out.json]     (on the card)
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

GRID = [(16, 3), (24, 3), (32, 3), (16, 4), (24, 4), (32, 4)]
REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def run_point(n, p, crosscheck):
    """The JSON record of one point, or None if its run printed none."""
    env = dict(os.environ)
    env.update(BENCH_N=str(n), BENCH_P=str(p), BENCH_PHASES="0",
               BENCH_CROSSCHECK="1" if crosscheck else "0")
    out = subprocess.run([sys.executable, "-m", "remhos_torch.bench"],
                         env=env, cwd=REPO, capture_output=True, text=True)
    rec = None
    for line in out.stdout.splitlines():
        if line.startswith("{"):
            rec = json.loads(line)
    if rec is None:
        print(f"point N={n} p={p} FAILED:\n{out.stderr[-1500:]}",
              file=sys.stderr)
        return None
    rec["n"] = n
    rec["p"] = p
    return rec


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    out_path = argv[0] if argv else "BENCH_SWEEP.json"
    points = []
    for n, p in GRID:
        rec = run_point(n, p, crosscheck=(n == 24 and p == 3))
        if rec:
            points.append(rec)
            print(json.dumps({k: rec.get(k) for k in
                              ("n", "p", "ndofs", "value", "verified",
                               "mass_rel_loss", "hbm_util_model",
                               "device")}), flush=True)
    if not points:
        return 1
    best = max(points, key=lambda r: r["value"])
    plateau = [r for r in points if r["value"] >= 0.9 * best["value"]]
    summary = {
        "metric": "fom_sweep_3d_remap_pa_f32",
        "unit": "MDOF*stages/s",
        "device": best["device"],
        "points": points,
        "best": {k: best[k] for k in ("n", "p", "ndofs", "value")},
        "plateau_ndofs_min": min(r["ndofs"] for r in plateau),
    }
    with open(out_path, "w") as fh:
        json.dump(summary, fh, indent=1)
    print(f"wrote {out_path}: best {best['value']} at N={best['n']} "
          f"p={best['p']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
