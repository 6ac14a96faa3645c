"""Element-local CG for the Gauss-Legendre mass inverse: wrapper, launch
count and plain PyTorch version.

`gl_cg` is the port of `fused_gl_cg` (remhos_tpu/ops/pallas_kernels.py:209):
MFEM's DGMassInverse local CG (remhos_ho.cpp:79-80) solved for every element
on its own, with the Jacobi preconditioner D = wdet Bgl2. b = rhs A; then
`n_iter` fixed iterations, each masked per element by the relative test
rr > rel_tol^2 rr0 taken from the previous iteration (a stopped element has
alpha = beta = 0: its state is frozen); pAp == 0 and rz == 0 are guarded;
out = x A^T. rel_tol defaults to 1e-6 in f32 and 1e-12 in f64. The kernel is
`csrc/gl_cg.cu` (CUDA C++, sm_90a), built by nvcc at first use and called
through ctypes.

The operator does not call it: its non-fused stage solves with
`pa.mass_solve_gl`, whose stopping test is global, as the JAX operator does
(remhos_tpu/operator.py:340-346). The TPU wrapper's `block_e` chooses a TPU
tiling; the port's tile is fixed at compile time.

On a CUDA tensor the wrapper launches the kernel or raises. On a CPU tensor,
and only then, it runs `gl_cg_reference`.
"""

from __future__ import annotations

import ctypes

import torch

from . import build
from . import stage_core as core

ARGTYPES = [ctypes.c_int, ctypes.POINTER(ctypes.c_void_p), ctypes.c_int,
            ctypes.c_double, ctypes.POINTER(ctypes.c_int), ctypes.c_int,
            ctypes.c_void_p]
TABLES = ("A", "AT", "BglT", "Bgl", "Bgl2")


def default_rel_tol(dtype) -> float:
    return 1e-6 if dtype == torch.float32 else 1e-12


def gl_cg_reference(rhs, wdet, tables, rel_tol=None, n_iter=16,
                    with_iterations=False):
    """Plain PyTorch version, on any device: the kernel's iteration with
    per-element [E, 1] scalars and masks. With `with_iterations` it also
    returns the iterations each element was live in, [E] (the work the
    kernel's data takes: utils/cost.gl_cg_cost)."""
    if rel_tol is None:
        rel_tol = default_rel_tol(rhs.dtype)
    A, AT, BglT, Bgl, Bgl2 = (tables[k] for k in TABLES)
    b = rhs @ A
    inv_diag = 1.0 / (wdet @ Bgl2)
    x = torch.zeros_like(b)
    r = b
    z = inv_diag * r
    p = z
    rz = (r * z).sum(dim=1, keepdim=True)
    rr = (r * r).sum(dim=1, keepdim=True)
    tol2 = (rel_tol * rel_tol) * rr
    its = torch.zeros_like(rr, dtype=torch.int64)
    for _ in range(n_iter):
        live = rr > tol2
        its += live
        Ap = ((p @ BglT) * wdet) @ Bgl
        pAp = (p * Ap).sum(dim=1, keepdim=True)
        alpha = torch.where(live, rz / torch.where(pAp != 0, pAp, 1.0), 0.0)
        x = x + alpha * p
        r = r - alpha * Ap
        z = inv_diag * r
        rz_new = (r * z).sum(dim=1, keepdim=True)
        beta = torch.where(live, rz_new / torch.where(rz != 0, rz, 1.0), 0.0)
        p = torch.where(live, z + beta * p, p)
        rz = torch.where(live, rz_new, rz)
        rr = torch.where(live, (r * r).sum(dim=1, keepdim=True), rr)
    return (x @ AT, its[:, 0]) if with_iterations else x @ AT


def gl_cg(rhs, wdet, tables, rel_tol=None, n_iter=16):
    """M_bern^-1 rhs [E, nd], element by element; wdet[E, Q] = w_q det J;
    `tables` holds A, AT, BglT, Bgl, Bgl2 (`ops.tables.stage_ho_tables`)."""
    if rhs.dim() != 2:
        raise ValueError(f"rhs must be [E, nd], got {tuple(rhs.shape)}")
    if n_iter < 0:
        raise ValueError(f"n_iter must be >= 0, got {n_iter}")
    if rel_tol is None:
        rel_tol = default_rel_tol(rhs.dtype)
    E, nd = rhs.shape
    Q = tables["Bgl"].shape[0]
    if nd != tables["nd"]:
        raise ValueError(f"rhs must be [E, {tables['nd']}], got "
                         f"{tuple(rhs.shape)}")
    core.check_operands("gl_cg", ("rhs", "wdet"), (rhs, wdet),
                        ((E, nd), (E, Q)), tables)
    if rhs.device.type == "cpu":
        return gl_cg_reference(rhs, wdet, tables, rel_tol, n_iter)
    out = torch.empty_like(rhs)
    tensors = [rhs, wdet] + [tables[k] for k in TABLES] + [out]
    ptrs = (ctypes.c_void_p * 8)(*[x.data_ptr() for x in tensors])
    sizes = (ctypes.c_int * 4)(E, nd, Q, n_iter)
    lib = build.bind(build.load("gl_cg"), "remhos_gl_cg", ARGTYPES)
    rc = build.call_on(rhs.device, lib.remhos_gl_cg, rhs.element_size(),
                       ptrs, 8, float(rel_tol) ** 2, sizes, 4)
    build.check(lib, rc, "gl_cg")
    gl_cg.launches += 1
    return out


gl_cg.launches = 0
