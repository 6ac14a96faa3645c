"""High-order (unlimited) solvers of the assembled path, du = M^-1 K_HO u:
the port of `remhos_tpu.ho` (remhos_ho.cpp).

- `local_inverse`: the per-element dense mass solve through batched
  Cholesky factors (LocalInverseHOSolver, remhos_ho.cpp:84-128; `-ho 3`);
- `cg_mass_solve`: Jacobi-preconditioned CG on the block-diagonal DG mass
  matrix (CGHOSolver, remhos_ho.cpp:30-70; `-ho 2`);
- `neumann`: the lumped-mass Neumann iteration with lumped face fluxes
  (NeumannHOSolver, remhos_ho.cpp:136-187; `-ho 1`).

The iterative solvers are Python loops that read their stopping test back
from the device once per iteration (the JAX package's `while_loop`), as
`pa.mass_solve_*` do; the CG's `stats` counts solves and iterations.
"""

from __future__ import annotations

import math

import torch

from .assembly import matvec
from .pa import _count, _dot
from .utils.trace import host_wait, spanned


def mass_cholesky(M):
    """Batched Cholesky factors L[E, nd, nd] of the SPD element mass
    matrices. The factorization's info is read back, a wait for the device
    (`host_wait`), and a matrix that is not positive definite raises, as
    `torch.linalg.cholesky` does with the same factors."""
    L, info = torch.linalg.cholesky_ex(M)
    if host_wait(bool, info.any()):
        raise torch.linalg.LinAlgError(
            f"mass_cholesky: {int((info > 0).sum())} of {M.shape[0]} "
            "element mass matrices are not positive definite")
    return L


def cho_solve(L, rhs):
    """x[E, nd] with (L L^T) x = rhs: two batched triangular solves."""
    y = torch.linalg.solve_triangular(L, rhs[:, :, None], upper=False)
    return torch.linalg.solve_triangular(L.transpose(1, 2), y,
                                         upper=True)[:, :, 0]


def local_inverse(Ku, chol_L):
    """du[E, nd] = M^-1 (K_HO u), element by element."""
    return cho_solve(chol_L, Ku)


@spanned("remhos.cg")
def cg_mass_solve(M, rhs, rel_tol=1e-12, max_iter=500, stats=None,
                  all_sum=None):
    """Jacobi-preconditioned CG for M du = rhs over all elements at once,
    stopping at (r, z) <= rel_tol^2 (r0, z0) as MFEM's CGSolver does;
    `all_sum` reduces the dots over the shards of a sharded run."""
    dot = _dot(all_sum)
    inv_diag = 1.0 / torch.diagonal(M, dim1=1, dim2=2)
    x = torch.zeros_like(rhs)
    r = rhs
    z = inv_diag * r
    p = z
    rz = dot(r, z)
    target = rel_tol * rel_tol * rz
    it = 0
    while it < max_iter and host_wait(bool, rz > target):
        Ap = matvec(M, p)
        alpha = rz / dot(p, Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        z = inv_diag * r
        rz_new = dot(r, z)
        p = z + (rz_new / rz) * p
        rz = rz_new
        it += 1
    _count(stats, it)
    return x


def neumann(u, rhs, M, ml, abs_tol=1e-4, max_iter=20, all_sum=None):
    """The lumped-mass Neumann iteration du <- du - (M du - rhs) / ml until
    |M du - rhs| <= abs_tol (remhos_ho.cpp:136-187). rhs: the element K u
    plus the LinearFluxLumping(alpha = 1) face terms and the inflow,
    assembled by the caller. `all_sum` reduces the residual norm over the
    shards (the reference's MPI_Allreduce, remhos_ho.cpp:176)."""
    dot = _dot(all_sum)
    du = torch.zeros_like(u)
    resid = math.inf
    it = 0
    while resid > abs_tol and it < max_iter:
        res = matvec(M, du) - rhs
        resid = host_wait(float, torch.sqrt(dot(res, res)))
        if resid > abs_tol:
            du = du - res / ml
        it += 1
    return du
