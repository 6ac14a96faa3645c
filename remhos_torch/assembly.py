"""Batched full-assembly operators and the DG face gather/scatter: the port
of `remhos_tpu.assembly`.

The assembled (FA) path keeps its matrices as dense per-element batches,
as the reference's ParBilinearForm assembly does per element
(remhos.cpp:638-727, Assembly::ComputeFluxTerms / LinearFluxLumping,
remhos_tools.cpp:788-913):

- `M[E, nd, nd]`: element mass matrices (MassIntegrator);
- `K[E, nd, nd]`: element convection (ConvectionIntegrator(v, sign));
- `bdrInt[E, nf, fd, fd]`: upwind face matrices per element face, entries
  >= 0, with the DG face action
      (K_HO u)|face_i += sum_j bdrInt[e, f, i, j] (u_nbr_j - u_own_j)
  (transport: vn = min(0, v.n); remap: vn = -max(0, v.n);
  remhos_tools.cpp:835-845).

Every contraction is one GEMM over a flattened batch, a matrix product
with batch E, or an elementwise product summed over the last axis: no
`torch.einsum` that torch would lower to a `bmm` with batch E*nf*Qf.
"""

from __future__ import annotations

import torch


def _outer_table(B):
    """[Q, n*n] table of B[q, i] B[q, j]: a q-weighted sum of it is one
    GEMM."""
    Q, n = B.shape
    return (B[:, :, None] * B[:, None, :]).reshape(Q, n * n)


def element_mass(detJ, Bu, w_q):
    """M[E, nd, nd] = sum_q w_q detJ[e, q] Bu[q, i] Bu[q, j]."""
    E, nd = detJ.shape[0], Bu.shape[1]
    return ((w_q[None, :] * detJ) @ _outer_table(Bu)).reshape(E, nd, nd)


def lumped_mass(M):
    """Row sums (LumpedIntegrator of MassIntegrator; remhos.cpp:705-720)."""
    return M.sum(dim=2)


def element_convection(v_q, adjJ, Bu, Gu, w_q, sign):
    """K[E, nd, nd] = sign sum_q w_q Bu[q, i] (adj J v)_q . Ghat_j[q].

    v_q[E, Q, dim]: the velocity at the volume points; adjJ[E, Q, dim, dim].
    det J J^-T grad_ref = adj J^T grad_ref, so there is no division. Staged:
    va = adj J v, then vg[e, q, j] = va . Gu[q, j] one reference direction
    at a time ([E, Q, nd] temporaries), then one matrix product with batch
    E."""
    va = (v_q[:, :, None, :] * adjJ).sum(-1)                 # [E, Q, dim]
    vg = va[:, :, 0, None] * Gu[None, :, :, 0]
    for b in range(1, va.shape[-1]):
        vg = vg + va[:, :, b, None] * Gu[None, :, :, b]      # [E, Q, nd]
    return sign * ((Bu * w_q[:, None]).T @ vg)


def face_upwind_matrices(v_fq, nor, w_fq, Bface, exec_mode):
    """bdrInt[E, nf, fd, fd] from the face velocities v_fq[E, nf, Qf, dim]
    and the scaled outward normals nor[E, nf, Qf, dim] (|nor| = the surface
    Jacobian, so min/max(0, v.n_hat)|n| = min/max(0, v.n))."""
    E, nf, Qf = nor.shape[:3]
    fd = Bface.shape[1]
    vn = (v_fq * nor).sum(-1)
    vns = vn.clamp(max=0.0) if exec_mode == 0 else -vn.clamp(min=0.0)
    wvn = -(w_fq[None, None, :] * vns)                       # >= 0
    return (wvn.reshape(E * nf, Qf) @ _outer_table(Bface)).reshape(
        E, nf, fd, fd)


def gather_face(u, bdr_dofs):
    """u_face[E, nf, fd] from u[E, nd]; bdr_dofs[nf, fd] is a long tensor."""
    return u[:, bdr_dofs]


def gather_nbr_face(u, nbr_elem, nbr_dof_local, bdr_value=None):
    """u on the NEIGHBOUR side of each face, u_nbr[E, nf, fd], through index
    tables (general meshes; remhos_tpu/assembly.py:70-87): nbr_elem[E, nf]
    (long, -1 on a physical boundary) and nbr_dof_local[E, nf, fd] or the
    shared [nf, fd] table (long). Boundary faces take bdr_value[E, nf, fd]
    (the inflow at this element's own face dofs, remhos_tools.cpp:891) or
    0. A plain index gather: no sum, so no order to keep."""
    if nbr_dof_local.dim() == 2:
        nbr_dof_local = nbr_dof_local[None]
    valid = (nbr_elem >= 0)[:, :, None]
    vals = u[nbr_elem.clamp(min=0)[:, :, None], nbr_dof_local]
    return torch.where(valid, vals, 0.0 if bdr_value is None else bdr_value)


def scatter_face_add(y, contrib, bdr_dofs):
    """y[E, nd] plus contrib[E, nf, fd] scattered to bdr_dofs. An edge or
    corner dof lies on several faces, so the indices repeat and the
    contributions accumulate: `index_add`, never an indexed assignment."""
    return y.index_add(1, bdr_dofs.reshape(-1),
                       contrib.reshape(y.shape[0], -1))


def face_term_full(u_face, u_nbr, bdrInt):
    """Full (Galerkin, alpha = 1) face contributions [E, nf, fd]:
    y_i += sum_j bdrInt[i, j] (u_nbr_j - u_own_j)."""
    return (bdrInt * (u_nbr - u_face)[:, :, None, :]).sum(-1)


def face_term_lumped(u_face, u_nbr, bdrInt):
    """Lumped (alpha = 0) face contributions [E, nf, fd]:
    y_i += (sum_j bdrInt[i, j]) (u_nbr_i - u_own_i) (LinearFluxLumping,
    remhos_tools.cpp:876-913)."""
    return bdrInt.sum(dim=3) * (u_nbr - u_face)


def matvec(A, u):
    """(A u)[E, n] of element blocks A[E, n, n] and u[E, n]."""
    return (A @ u[:, :, None])[:, :, 0]


def apply_K_HO(u, K_elem, bdrInt, u_nbr, bdr_dofs):
    """(K_HO u)[E, nd]: element convection plus the full DG face coupling
    (K_HO = ConvectionIntegrator + Transpose(DGTraceIntegrator),
    remhos.cpp:646-679); u_nbr as given on boundary faces (zero for the HO
    operator: the reference adds no boundary term to K_HO)."""
    contrib = face_term_full(gather_face(u, bdr_dofs), u_nbr, bdrInt)
    return scatter_face_add(matvec(K_elem, u), contrib, bdr_dofs)
