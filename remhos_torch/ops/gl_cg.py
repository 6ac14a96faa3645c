"""Element-local CG for the Gauss-Legendre mass inverse: wrapper, launch
count and plain PyTorch version.

`gl_cg` is the port of `fused_gl_cg` (remhos_tpu/ops/pallas_kernels.py:209):
MFEM's DGMassInverse local CG (remhos_ho.cpp:79-80) solved for every element
on its own, with the Jacobi preconditioner D = wdet Bgl2. b = rhs A; then
`n_iter` fixed iterations, each masked per element by the relative test
rr > rel_tol^2 rr0 taken from the previous iteration (a stopped element has
alpha = beta = 0: its state is frozen); pAp == 0 and rz == 0 are guarded;
out = x A^T. rel_tol defaults to 1e-6 in f32 and 1e-12 in f64. The kernel is
`csrc/gl_cg.cu` (CUDA C++, sm_90a): every product sum-factorized on the
1D tables `sf` of `ops.tables.stage_ho_tables`, with the passes of the
stage core (`csrc/stage_core.cuh`), built by nvcc at first use and called
through ctypes.

The operator does not call it: its non-fused stage solves with
`pa.mass_solve_gl`, whose stopping test is global, as the JAX operator does
(remhos_tpu/operator.py:340-346). The TPU wrapper's `block_e` chooses a TPU
tiling; the port's tile is chosen by the launcher for the shared memory.

The tables are checked once, at the first call with a table dict (recorded
in it under `CHECKED`), and the launch path is the stage kernels'
(`stage_core.Launcher`: pointers and sizes kept per table dict); per call
only rhs and wdet are checked. On a CUDA tensor the wrapper launches the
kernel or raises. On a CPU tensor, and only then, it runs
`gl_cg_reference`.
"""

from __future__ import annotations

import ctypes

import torch

from . import stage_core as core
from .tables import SF_TABLES, check_tables

ARGTYPES = [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_void_p),
            ctypes.c_int, ctypes.c_double, ctypes.POINTER(ctypes.c_int),
            ctypes.c_int, ctypes.c_void_p]
# the dense tables of the plain version
TABLES = ("A", "AT", "BglT", "Bgl", "Bgl2")
# pointer order of the C interface of csrc/gl_cg.cu (sf_host: a host copy
# of sf, which the kernel takes as parameters at compiled sizes)
OPERANDS = ("rhs", "wdet", "sf", "sf_host", "out")
# the record of the one-time check of the tables
CHECKED = "checked_gl_cg"


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


def check_gl_cg_tables(tables):
    """Check the tables kernel 6 and its plain version read, once: the
    dense tables, the 1D factors sf and w_q (`tables.check_tables`, under
    the key CHECKED). Returns (dtype, device)."""
    tb = tables
    nd, Q, D, Q1 = tb["nd"], tb["Q"], tb["D"], tb["Q1"]
    shapes = dict(A=(nd, nd), AT=(nd, nd), BglT=(nd, Q), Bgl=(Q, nd),
                  Bgl2=(Q, nd), w_q=(Q,),
                  sf=((len(SF_TABLES) - 1) * Q1 * D + D * D,))
    return check_tables(tb, shapes=shapes, key=CHECKED)


def gl_cg(rhs, wdet, tables, rel_tol=None, n_iter=16):
    """M_bern^-1 rhs [E, nd], element by element; wdet[E, Q] = w_q det J;
    `tables` from `ops.tables.stage_ho_tables` (the kernel reads its 1D
    factors sf, the plain version A, AT, BglT, Bgl, Bgl2)."""
    if rhs.dim() != 2:
        raise ValueError(f"rhs must be [E, nd], got {tuple(rhs.shape)}")
    if n_iter < 0:
        raise ValueError(f"n_iter must be >= 0, got {n_iter}")
    if rel_tol is None:
        rel_tol = default_rel_tol(rhs.dtype)
    tb = tables
    if CHECKED not in tb:
        check_gl_cg_tables(tb)
    E, nd = rhs.shape
    if nd != tb["nd"]:
        raise ValueError(f"rhs must be [E, {tb['nd']}], got "
                         f"{tuple(rhs.shape)}")
    core.check_operands("gl_cg", ("rhs", "wdet"), (rhs, wdet),
                        ((E, nd), (E, tb["Q"])), tb, key=CHECKED)
    if rhs.device.type == "cpu":
        return gl_cg_reference(rhs, wdet, tb, rel_tol, n_iter)
    out = torch.empty_like(rhs)
    if "sf_host" not in tb:
        tb["sf_host"] = tb["sf"].cpu()
    lau = core.Launcher.get("gl_cg", "remhos_gl_cg", ARGTYPES, tb, OPERANDS,
                            ("sf", "sf_host"), core.core_sizes(tb, E, n_iter))
    lau(rhs.device, (rhs.element_size(), tb["dim"]), (rhs, wdet, out),
        (float(rel_tol) ** 2,), E, n_iter)
    gl_cg.launches += 1
    return out


gl_cg.launches = 0
