"""Kernel 3 (`csrc/wdet.cu`) built with other launch bounds and timed on the
card against the shipped build (dev tool).

A variant k is wdet.cu with `__launch_bounds__(NT)` replaced by
`__launch_bounds__(NT, k)`: at least k resident blocks an SM, so fewer
registers a thread, and spills where the code does not fit in them. The
variants are built by nvcc (one process each, started together) into the
build directory, checked bit for bit against the shipped kernel, and timed
in turns by CUDA events over back-to-back launches of each library's C
entry. Called without the Python wrapper, the launches queue faster than
the kernel runs, so the device sets the pace.

    python -m remhos_torch.tools.wdet_variants     (BENCH_N=24, BENCH_P=3)
"""

from __future__ import annotations

import ctypes
import json
import subprocess

import torch

from .. import resolve_device
from ..ops import build
from ..ops import wdet as wd
from .microbench import setup

MIN_BLOCKS = (4, 5, 6, 8)
TURNS, N_INNER = 3, 200


def start_variant(k):
    """Start nvcc on wdet.cu with at least k resident blocks an SM; returns
    (process, library path)."""
    src = (build.CSRC / "wdet.cu").read_text()
    patched = src.replace("__launch_bounds__(NT)",
                          f"__launch_bounds__(NT, {k})")
    if patched == src:
        raise RuntimeError("wdet.cu has no __launch_bounds__(NT) to vary")
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu = build.BUILD_DIR / f"wdet_min_blocks_{k}.cu"
    cu.write_text(patched)
    so = cu.with_suffix(".so")
    cmd = [build._nvcc(), "-gencode", build.ARCH, "-std=c++17", "-O3",
           "-shared", "-Xcompiler", "-fPIC", f"-I{build.CSRC}", "-o",
           str(so), str(cu)]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True), so


def events_ms(fn, n):
    """Mean ms per call of fn over n back-to-back calls (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / n


def main(device=None):
    """Time the shipped kernel and the MIN_BLOCKS variants at BENCH_N^3,
    p = BENCH_P, in f32 and f64 on `device` (None: the card); prints and
    returns {dtype: {variant: [ms per turn]}}."""
    device = resolve_device(device)
    procs = {k: start_variant(k) for k in MIN_BLOCKS}
    fns = {"shipped": build.bind(build.load("wdet"), "remhos_wdet",
                                 wd.ARGTYPES).remhos_wdet}
    for k, (proc, so) in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for variant {k}:\n{err}")
        fn = ctypes.CDLL(str(so)).remhos_wdet
        fn.argtypes, fn.restype = wd.ARGTYPES, ctypes.c_int
        fns[f"min_blocks {k}"] = fn
    out = {}
    for w in (torch.float32, torch.float64):
        _, adv, x0, v, _, _ = setup(device, w)
        tb = adv._wdet_tables
        xs = (x0 + 0.3 * v).contiguous()
        ref = wd.wdet(xs, tb)
        got = torch.empty_like(ref)
        E, nm, dim = xs.shape
        sizes = (ctypes.c_int * 5)(E, nm, ref.shape[1], tb["m1"], tb["Q1"])
        stream = torch.cuda.current_stream(device).cuda_stream
        args = (xs.element_size(), dim, xs.data_ptr(), tb["msf"].data_ptr(),
                tb["w_q"].data_ptr(), got.data_ptr(), sizes, 5, stream)
        times = {name: [] for name in fns}
        for name, fn in fns.items():
            got.zero_()
            rc = fn(*args)
            torch.cuda.synchronize()
            if rc != 0 or not torch.equal(got, ref):
                raise RuntimeError(f"{name}: rc {rc} or not the kernel's wdet")
        for _ in range(TURNS):
            for name, fn in fns.items():
                times[name].append(events_ms(lambda fn=fn: fn(*args), N_INNER))
        out[str(w).replace("torch.", "")] = times
        print(json.dumps({"dtype": str(w), "E": E, "ms": times}), flush=True)
    return out


if __name__ == "__main__":
    main()
