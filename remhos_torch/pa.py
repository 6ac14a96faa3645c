"""Partial-assembly (matrix-free) operator actions, batched over all
elements as plain torch products: the port of `remhos_tpu.pa`.

- convection action   K u = ((u Gu_b^T) * va_b) (w Bu)   (per reference dim b)
- mass action         M u = ((u Bu^T) * wdet) Bu
- mass inverse        Jacobi-preconditioned CG, in the Gauss-Legendre nodal
                      basis (`mass_solve_gl`, MFEM's DGMassInverse,
                      remhos_ho.cpp:79-80) or on the Bernstein mass action
                      (`mass_solve_bern`, CGHOSolver, remhos_ho.cpp:40-65)
- DG face terms       ((u_nbr - u_own) Bface^T * wvn) Bface

Both CG solves stop on a GLOBAL test: the dots run over every element, and
the loop ends when the residual norm falls below its target. To take the
reference's number of iterations the loop reads that one comparison back
from the device every iteration. `stats`, a dict the caller owns, counts
`solves` and `iterations`.

Every float32 product here is a true float32 product (TF32 is off package
wide): the GL<->Bernstein change of basis is a cancellation hotspot.
"""

from __future__ import annotations

import torch


def conv_action(u, va, Gu, Bu_w):
    """(K u)[E, nd] = sign * int (v.grad u) phi_i, matrix-free.

    va:   [E, Q, dim]  sign * (adj J v) at the quadrature points
    Gu:   [Q, nd, dim] reference gradients
    Bu_w: [Q, nd]      w_q * Bu (test functions pre-weighted)
    """
    du_q = torch.einsum("ej,qjb,eqb->eq", u, Gu, va)
    return du_q @ Bu_w


def mass_action(u, wdet, Bu):
    """(M u)[E, nd] with wdet[E, Q] = w_q det J."""
    return ((u @ Bu.T) * wdet) @ Bu


def lumped_mass_pa(wdet, Bu):
    """ml = M.1 = Bu^T (w det J): Bernstein is a partition of unity."""
    return wdet @ Bu


def face_flux_q(u_face, u_nbr, Bface, wvn):
    """Upwind flux at the face points: [E, nf, Qf] = wvn * (u_nbr - u_own)_q,
    with wvn[E, nf, Qf] = -w_fq * vn_signed >= 0."""
    return wvn * torch.einsum("efj,qj->efq", u_nbr - u_face, Bface)


def face_full_apply(u_face, u_nbr, Bface, wvn):
    """Full (Galerkin) DG face contributions [E, nf, fd]."""
    fq = face_flux_q(u_face, u_nbr, Bface, wvn)
    return torch.einsum("efq,qi->efi", fq, Bface)


def face_lumped_apply(u_face, u_nbr, Bface, wvn):
    """Lumped (alpha = 0) face contributions [E, nf, fd]: the row sums
    Bface^T wvn times (u_nbr_i - u_own_i)."""
    row = torch.einsum("efq,qi->efi", wvn, Bface)
    return row * (u_nbr - u_face)


def _count(stats, it):
    if stats is not None:
        stats["solves"] = stats.get("solves", 0) + 1
        stats["iterations"] = stats.get("iterations", 0) + it


def mass_solve_gl(rhs, wdet, Bgl, A_gl2b, rel_tol=None, max_iter=60,
                  stats=None):
    """Solve M_bern du = rhs by CG in the Gauss-Legendre nodal basis.

    With du = A g (A the GL -> Bernstein change of basis), M_bern A g = rhs
    becomes A^T M_bern A g = M_gl g = A^T rhs; M_gl is near-diagonal, so
    Jacobi-preconditioned CG converges in a few iterations. Stopping is
    relative, |r| <= rel_tol |b| over all elements (1e-6 in float32, 1e-12
    in float64): mass rows scale with the element volume, so MFEM's nominal
    absolute 1e-8 would depend on the mesh size."""
    if rel_tol is None:
        rel_tol = 1e-6 if rhs.dtype == torch.float32 else 1e-12
    b = rhs @ A_gl2b                        # A^T rhs -> [E, nd]
    inv_diag = 1.0 / (wdet @ (Bgl * Bgl))   # 1 / diag(M_gl)[e, i]

    x = torch.zeros_like(b)
    r = b
    z = inv_diag * r
    p = z
    rz = (r * z).sum()
    tol2 = rel_tol * rel_tol * (b * b).sum()
    rr = (r * r).sum()
    it = 0
    while it < max_iter and bool(rr > tol2):
        Ap = ((p @ Bgl.T) * wdet) @ Bgl
        alpha = rz / (p * Ap).sum()
        x = x + alpha * p
        r = r - alpha * Ap
        z = inv_diag * r
        rz_new = (r * z).sum()
        p = z + (rz_new / rz) * p
        rz, rr = rz_new, (r * r).sum()
        it += 1
    _count(stats, it)
    return x @ A_gl2b.T                     # du = A g


def mass_solve_bern(rhs, wdet, Bu, rel_tol=1e-12, max_iter=500, stats=None):
    """Jacobi-CG on the Bernstein mass action (CGHOSolver's PA path:
    OperatorJacobiSmoother and rel_tol 1e-12, remhos_ho.cpp:40-65; the
    tolerance is clamped to 1e-6 in float32)."""
    if rhs.dtype == torch.float32:
        rel_tol = max(rel_tol, 1e-6)
    inv_diag = 1.0 / (wdet @ (Bu * Bu))

    x = torch.zeros_like(rhs)
    r = rhs
    z = inv_diag * r
    p = z
    rz = (r * z).sum()
    target = rel_tol * rel_tol * rz
    it = 0
    while it < max_iter and bool(rz > target):
        Ap = mass_action(p, wdet, Bu)
        alpha = rz / (p * Ap).sum()
        x = x + alpha * p
        r = r - alpha * Ap
        z = inv_diag * r
        rz_new = (r * z).sum()
        p = z + (rz_new / rz) * p
        rz = rz_new
        it += 1
    _count(stats, it)
    return x
