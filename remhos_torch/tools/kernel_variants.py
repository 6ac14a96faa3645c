"""Kernels 3, 5 and 6 rebuilt from their sources with other occupancy, tile
or layout choices and timed on the card against the shipped build (dev
tool).

A variant is the kernel's source with the text substitutions of
`VARIANTS[kernel][name]` (the choices each source names: launch bounds,
blocks an SM, elements a tile, where an array lies). The variants are built
by nvcc (one process each, started together) into the build directory,
checked bit for bit against the shipped kernel (none of these choices
changes a sum), and timed in turns by CUDA events over back-to-back
launches of each library's C entry, which queue faster than the kernels
run: the device sets the pace. The inputs are microbench's case at
BENCH_N^3, p = BENCH_P, nodes x0 + 0.3 v: wdet; gl_cg on a random
right-hand side; stage_ho_nodes with its defaults on a random u.

    python -m remhos_torch.tools.kernel_variants [wdet] [gl_cg] [stage_ho_nodes]
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys

import torch

from .. import resolve_device
from ..ops import build
from ..ops import gl_cg as cg
from ..ops import stage_ho_nodes as shn
from ..ops import wdet as wd
from .microbench import setup

_CG_BLOCKS = "constexpr int CG_BLOCKS_F32 = 4, CG_BLOCKS_F64 = 3;"
_CG_TILE = "constexpr int CG_TILE_THREADS = NT / 2;"
VARIANTS = {
    "wdet": {f"min_blocks {k}": (("__launch_bounds__(NT)",
                                  f"__launch_bounds__(NT, {k})"),)
             for k in (4, 5, 6, 8)},
    "gl_cg": {
        "blocks 3/2": ((_CG_BLOCKS, _CG_BLOCKS.replace("4, ", "3, ")
                        .replace("3;", "2;")),),
        "full tile": ((_CG_TILE, _CG_TILE.replace("NT / 2", "NT")),),
        "quarter tile": ((_CG_TILE, _CG_TILE.replace("NT / 2", "NT / 4")),),
        "full tile, blocks 3/2": (
            (_CG_TILE, _CG_TILE.replace("NT / 2", "NT")),
            (_CG_BLOCKS, _CG_BLOCKS.replace("4, ", "3, ")
             .replace("3;", "2;"))),
    },
    "stage_ho_nodes": {
        "2 blocks an SM in f32": (
            ("return (228 * 1024) / min_blocks<T>() - 1024;",
             "return SMEM_BUDGET;"),),
        "vn after the core's arrays": (
            ("if (vn <= L.cf - L.inv) {", "if (false) {"),),
    },
}
TURNS, N_INNER = 3, 200


def start_variant(kernel, name, patches):
    """Start nvcc on the kernel's source with `patches` applied; returns
    (process, library path)."""
    src = (build.CSRC / f"{kernel}.cu").read_text()
    for old, new in patches:
        if old not in src:
            raise RuntimeError(f"{kernel}.cu has no {old!r} to vary")
        src = src.replace(old, new)
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = "".join(c if c.isalnum() else "_" for c in name)
    cu = build.BUILD_DIR / f"{kernel}_{tag}.cu"
    cu.write_text(src)
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


def case(kernel, device, w):
    """(entry name, argtypes, C entry arguments, outputs, inputs) of one
    launch of the shipped kernel through its wrapper; the outputs hold its
    results, the inputs are kept alive for the pointers. gl_cg and
    stage_ho_nodes reuse their launcher's pointer and size arrays
    (`stage_core.Launcher`: the last launch's arguments)."""
    _, adv, x0, v, u0, _ = setup(device, w)
    xs = (x0 + 0.3 * v).contiguous()
    stream = torch.cuda.current_stream(device).cuda_stream
    if kernel == "wdet":
        tb = adv._wdet_tables
        out = wd.wdet(xs, tb)
        E, nm, dim = xs.shape
        sizes = (ctypes.c_int * 5)(E, nm, out.shape[1], tb["m1"], tb["Q1"])
        args = (xs.element_size(), dim, xs.data_ptr(), tb["msf"].data_ptr(),
                tb["w_q"].data_ptr(), out.data_ptr(), sizes, 5, stream)
        return "remhos_wdet", wd.ARGTYPES, args, (out,), (xs,)
    g = torch.Generator(device=device).manual_seed(5)
    u = torch.randn(u0.shape, generator=g, dtype=w, device=device)
    if kernel == "gl_cg":
        tb = adv._stage_tables
        keep = (u, wd.wdet(xs, adv._wdet_tables))
        outs = (cg.gl_cg(*keep, tb),)
        entry, argtypes = "remhos_gl_cg", cg.ARGTYPES
        tail = (cg.default_rel_tol(w) ** 2,)
    else:
        tb = shn.stage_ho_nodes_tables(adv.disc, w, device)
        keep = (xs, v, u, adv.gather_nbr(u).reshape(u.shape[0], -1))
        outs = shn.stage_ho_nodes(*keep, tb, mode=1.0)
        entry, argtypes, tail = "remhos_stage_ho_nodes", shn.ARGTYPES, (1.0,)
    lau = tb[("launcher", entry)]
    args = (u.element_size(), tb["dim"], lau.ptrs, len(lau.ptrs), *tail,
            lau.sizes, len(lau.sizes), stream)
    return entry, argtypes, args, outs, (keep, tb)


def main(kernels=None, device=None):
    """Time each kernel's shipped build and its VARIANTS in f32 and f64 on
    `device` (None: the card); prints and returns {kernel: {dtype:
    {variant: [ms per turn]}}}."""
    device = resolve_device(device)
    kernels = list(kernels or VARIANTS)
    procs = {(k, n): start_variant(k, n, p)
             for k in kernels for n, p in VARIANTS[k].items()}
    out = {}
    for kernel in kernels:
        for w in (torch.float32, torch.float64):
            entry, argtypes, args, outs, _keep = case(kernel, device, w)
            fns = {"shipped": getattr(build.load(kernel), entry)}
            for (k, name), (proc, so) in procs.items():
                if k != kernel:
                    continue
                if proc.returncode is None:
                    _, err = proc.communicate()
                    if proc.returncode != 0:
                        raise RuntimeError(f"nvcc failed for {kernel} "
                                           f"{name}:\n{err}")
                fn = getattr(ctypes.CDLL(str(so)), entry)
                fn.argtypes, fn.restype = argtypes, ctypes.c_int
                fns[name] = fn
            ref = [x.clone() for x in outs]
            for name, fn in fns.items():
                for x in outs:
                    x.zero_()
                rc = fn(*args)
                torch.cuda.synchronize()
                if rc != 0 or not all(torch.equal(x, r)
                                      for x, r in zip(outs, ref)):
                    raise RuntimeError(f"{kernel} {name}: rc {rc} or not "
                                       "the shipped kernel's result")
            times = {name: [] for name in fns}
            for _ in range(TURNS):
                for name, fn in fns.items():
                    times[name].append(events_ms(lambda fn=fn: fn(*args),
                                                 N_INNER))
            out.setdefault(kernel, {})[str(w).replace("torch.", "")] = times
            print(json.dumps({"kernel": kernel, "dtype": str(w),
                              "E": outs[0].shape[0], "ms": times}),
                  flush=True)
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
