#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (remhos_torch) on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py
It builds the CUDA kernels from the sources on first use, then:

1. prints the card's name and power limit (nvidia-smi);
2. builds the kernel library and prints the build time;
3. holds every kernel against its plain PyTorch version on the card, on
   the same inputs from a numpy seed: one stage at N=24, p=3 in 3D in f32
   and f64, and on a small 2D mesh. Limits, relative to max|du|: 1e-10 in
   f64 (round-off), 2e-4 in f32;
4. drives the main path: bench.build_case(n=24, order=3, f32) and 320 RK3
   steps at dt = 0.2/320 with the mass closures, bench.verify and the 2-step
   f32-vs-f64 cross check; asserts that the kernel ran on every stage;
5. prints one JSON line per result and a `kernels` line;
6. ends with {"ok": true, "device": {...}}.

Any failure raises and exits nonzero; without CUDA it exits 2 and prints no
result.
"""

import json
import subprocess
import sys
import time

import numpy as np
import torch

from remhos_torch import bench, bounds, structured
from remhos_torch.ops import build
from remhos_torch.ops import mega_stage as ms

# NVIDIA H100 SXM data sheet: HBM3 rate and the card's peak rate for each
# type: f32 outside the tensor cores (no tensor-core f32 keeps its
# accuracy), f64 through the tensor cores (DMMA), the faster of its two
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 67e12}
# kernel against plain version, relative to max|du|: f64 round-off; f32
# 10x above the ~2e-5 FMA-ordering difference, below the ~2.5e-3 a lost
# Jacobi sweep would make
LIMITS = {torch.float32: 2e-4, torch.float64: 1e-10}
N_MAIN, ORDER, STEPS = 24, 3, 320
SEED = 20261016


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps):
    """Mean device time of `fn` over `reps` calls, from CUDA events."""
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def tensor_macs(n, q, d):
    """Multiply-adds of one sum-factorized contraction between n^d values
    and q^d values (either way), one direction at a time."""
    lo, hi = min(n, q), max(n, q)
    return sum(hi ** k * lo ** (d - k + 1) for k in range(1, d + 1))


def stage_cost(tb, P, n_cg):
    """(bytes, flops) one mega stage needs at the least, from its shapes.

    Bytes: each input read once (u, u_nbr, P, the two stencil arrays, the
    tables), the output du written once. Flops: 2 per multiply-add, every
    table contraction counted at its sum-factorized size (the tables are
    tensor products of 1D ones: n1 = p+1 dofs and q1 points per direction),
    plus the pointwise work."""
    dim, nd, Q, Qf, nf, fd = (tb[k] for k in ("dim", "nd", "Q", "Qf", "nf",
                                               "fd"))
    n1, q1 = round(nd ** (1 / dim)), round(Q ** (1 / dim))
    assert (n1 ** dim, q1 ** dim, n1 ** (dim - 1), q1 ** (dim - 1)) == (
        nd, Q, fd, Qf), "the tables are not tensor products"
    FQ, NFD, ncls = nf * Qf, nf * fd, 3 ** dim
    E, itemsize = P.shape[0], P.element_size()
    tables = sum(v.numel() * v.element_size() for v in tb.values()
                 if torch.is_tensor(v))
    nbytes = (E * (2 * nd + NFD + 2 * ncls) * itemsize
              + P.numel() * itemsize + tables)
    vol = tensor_macs(n1, q1, dim)        # dofs <-> volume points
    face = nf * tensor_macs(n1, q1, dim - 1)
    mac = (dim * vol                  # reference gradients of u
           + vol + face               # volume and face parts of Ku
           + 2 * face                 # own and neighbour face traces
           + 2 * tensor_macs(n1, n1, dim)   # b = Ku A, du_HO = x A^T
           + vol + vol                # the Jacobi diagonal, lumped mass
           + n_cg * 2 * vol           # Jacobi sweeps
           + Q * dim * (dim - 1) + Q * dim + FQ * (dim - 1))  # Horner
    pointwise = 2 * dim * Q + 3 * FQ + n_cg * (Q + 3 * nd) + 30 * nd
    return nbytes, E * (2 * mac + pointwise)


def bound(tb, P, n_cg):
    nbytes, flops = stage_cost(tb, P, n_cg)
    t_b, t_f = nbytes / PEAK_BYTES_PER_S, flops / PEAK_FLOPS[P.dtype]
    return dict(bound_ms=1e3 * max(t_b, t_f),
                bound_by="bytes" if t_b >= t_f else "operations",
                bytes=nbytes, flops=flops)


def check_kernel(label, adv, dt, rng):
    """One stage, kernel vs plain version, on random u; raises beyond the
    limit. Returns the measured numbers."""
    dtype = adv.dtype
    u = torch.as_tensor(rng.random((adv._poly.shape[0],
                                    adv._stage_tables["nd"])),
                        dtype=dtype, device="cuda")
    unbr = adv.gather_nbr(u).reshape(u.shape[0], -1)
    smin, smax = structured.overlap_stencil_T(
        *bounds.elements_min_max(u), adv.shape, adv.periodic, adv.masks)
    args = (0.1, dt, u, unbr, smin, smax, adv._poly, adv._stage_tables)
    n_cg = ms.default_sweeps(dtype)
    got = ms.mega_stage(*args)
    torch.cuda.synchronize()
    ref = ms.mega_stage_reference(*args, n_cg)
    torch.cuda.synchronize()
    err = float((got - ref).abs().max())
    scale = float(ref.abs().max())
    if not (np.isfinite(err) and err <= LIMITS[dtype] * scale):
        raise RuntimeError(f"{label}: kernel disagrees with its plain "
                           f"version: max|d du| {err:g}, max|du| {scale:g}")
    res = dict(check=label, E=u.shape[0], max_abs_err=err,
               rel_err=err / scale, limit=LIMITS[dtype],
               ms=time_ms(lambda: ms.mega_stage(*args), 20),
               plain_ms=time_ms(
                   lambda: ms.mega_stage_reference(*args, n_cg), 5))
    res.update(bound(adv._stage_tables, adv._poly, n_cg))
    print(json.dumps(res), flush=True)
    return res


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)

    # 1. the card
    card = card_line()
    print(card, flush=True)

    # 2. build
    t0 = time.perf_counter()
    lib = build.build("mega_stage", ms.SOURCES)
    build_s = time.perf_counter() - t0
    regs = [ln.strip() for ln in lib.with_suffix(".log").read_text()
            .splitlines() if "registers" in ln]
    print(json.dumps({"build_s": build_s, "library": lib.name,
                      "ptxas": regs}), flush=True)

    # 3. kernel against plain version, f32 and f64, N=24 3D and a 2D mesh
    rng = np.random.default_rng(SEED)
    checks = {}
    case = bench.build_case(N_MAIN, ORDER, torch.float32, dev,
                            n_steps=STEPS)
    checks["3d_f32"] = check_kernel("3d N=24 f32", case.adv, case.dt, rng)
    checks["3d_f64"] = check_kernel("3d N=24 f64", case.adv64, case.dt, rng)
    case2 = bench.build_case(16, ORDER, torch.float32, dev, n_steps=STEPS,
                             dim=2)
    checks["2d_f32"] = check_kernel("2d 16x16 f32", case2.adv, case2.dt, rng)
    checks["2d_f64"] = check_kernel("2d 16x16 f64", case2.adv64, case2.dt,
                                    rng)
    del case, case2
    torch.cuda.empty_cache()

    # 4. the main path, counted
    ms.mega_stage.launches = 0
    case = bench.build_case(N_MAIN, ORDER, torch.float32, dev,
                            n_steps=STEPS)
    rec = bench.run(case)
    launches = ms.mega_stage.launches
    want = bench.STAGES * (case.n_steps + 2 + 2)   # + the cross check's steps
    if launches != want:
        raise RuntimeError(f"mega_stage launched {launches} times on the "
                           f"main path, expected {want}")
    u = case.u0
    adv = case.adv
    unbr = adv.gather_nbr(u).reshape(u.shape[0], -1)
    smin, smax = structured.overlap_stencil_T(
        *bounds.elements_min_max(u), adv.shape, adv.periodic, adv.masks)
    kernel_ms = time_ms(lambda: ms.mega_stage(
        0.1, case.dt, u, unbr, smin, smax, adv._poly, adv._stage_tables), 50)
    rec.update(kernel_ms_per_launch=kernel_ms, mega_stage_launches=launches,
               card=card)
    print(json.dumps(rec), flush=True)

    # 5. every ported kernel
    c32, c64 = checks["3d_f32"], checks["3d_f64"]
    kernels = [{
        "name": "mega_stage",
        "route": "cuda",
        "source": "remhos_torch/ops/csrc/mega_stage.cu",
        "replaces": "remhos_tpu/ops/pallas_kernels.py:889",
        "launches": launches,
        "max_abs_err": c32["max_abs_err"],
        "ms": kernel_ms,
        "plain_ms": c32["plain_ms"],
        "bound_ms": c32["bound_ms"],
        "bound_by": c32["bound_by"],
        "library_ms": None,
        "f64": {k: c64[k] for k in ("max_abs_err", "ms", "plain_ms",
                                    "bound_ms", "bound_by")},
        "checks": [{k: c[k] for k in ("check", "max_abs_err", "rel_err",
                                      "limit")} for c in checks.values()],
    }]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
