"""Differential timing of the full HO stage kernel's sections (dev tool).

The counterpart of tools/kernelbench.py: kernel 5 (`ops.stage_ho_nodes`,
the HO stage with the geometry from the nodes) with the volume part only,
with the face flux, and with the mass inverse (3 sweeps), each over a loop
of n launches on the card (microbench's `scan_time`). The JAX tool's KB_BE
sets the TPU block size; the port's tile is fixed at compile time, so it
has no such knob.

    python -m remhos_torch.tools.kernelbench     (BENCH_N=24, BENCH_P=3)
"""

from __future__ import annotations

import torch

from .. import resolve_device
from ..ops import stage_ho_nodes as shn
from .microbench import scan_time, setup

N_INNER = 50
CASES = [
    ("volume only (n_cg=0)", dict(n_cg=0, with_face=False)),
    ("vol+face   (n_cg=0)", dict(n_cg=0)),
    ("vol+face   (n_cg=3)", dict(n_cg=3)),
]


def main(device=None, n_inner=N_INNER):
    """Print the three sections' times at BENCH_N^3, p = BENCH_P, f32, on
    `device` (None: the card); returns them, in ms, by label."""
    device = resolve_device(device)
    w = torch.float32
    disc, adv, x0, v, u0, _ = setup(device, w)
    E, nd = u0.shape
    print(f"E={E} nd={nd} Q={len(disc.w_q)} nm={disc.Bm.shape[1]}",
          flush=True)
    tables = shn.stage_ho_nodes_tables(disc, w, device)
    xs = x0 + 0.1 * v
    unbr = adv.gather_nbr(u0).reshape(E, -1)
    out = {}
    for label, kw in CASES:
        ms = 1e3 * scan_time(lambda u, kw=kw: shn.stage_ho_nodes(
            xs, v, u, unbr, tables, mode=1.0, **kw)[0], u0, n=n_inner)
        out[label] = ms
        print(f"{label}  {ms:8.3f} ms", flush=True)
    return out


if __name__ == "__main__":
    main()
