"""Flux-based (Zalesak) FCT, `-fct 1`: the port of `remhos_tpu.fct_flux`
(FluxBasedFCT, remhos_fct.cpp:155-446).

The antidiffusive fluxes are F_ij = dt d_ij (u_i - u_j) + dt M_ij (duHO_i -
duHO_j) with d_ij = max(0, -k_ij, -k_ji) on the sparsity of K_HO
(remhos_fct.cpp:307-320). For the Bernstein basis the cross-element entries
of K_HO are >= 0 (phi >= 0 pointwise), so the cross-element d_ij vanish and
M is block-diagonal: every surviving flux is intra-element and lives in a
dense [E, nd, nd] block. The intra-element d_ij do include the own-own
terms of the DG trace, which `k_ho_diag_blocks` adds to the convection
blocks. On the card, for the elements `ops/fa_fct.engages` takes,
`flux_based_fct` is one launch of that kernel (in its caller's
`remhos.fct` span), which keeps every [E, nd, nd] block on chip. Elsewhere
the flux blocks are formed in a `remhos.flux` span and the Zalesak sweeps
are their caller's own time.
"""

from __future__ import annotations

import torch

from . import sync as syncm
from .ops import fa_fct as ffm
from .utils.trace import spanned


def k_ho_diag_blocks(K_elem, bdrInt, bdr_dofs):
    """The element-diagonal blocks of K_HO: convection plus the own-own DG
    trace terms. From (Ku)_i += sum_j bdrInt[i, j] (u_nbr - u_own)_j the
    own-own coupling is -bdrInt at the face dofs, added face by face in
    face order through a flat index of the block (within a face the pairs
    are distinct; an edge or corner pair repeats across faces and
    accumulates)."""
    E, nd = K_elem.shape[:2]
    D = K_elem.clone()
    flat = D.view(E, nd * nd)
    for f in range(bdrInt.shape[1]):
        idx = bdr_dofs[f]
        flat.index_add_(1, (idx[:, None] * nd + idx[None, :]).reshape(-1),
                        -bdrInt[:, f].reshape(E, -1))
    return D


def _fct_iterations(F, u, du_lo, m, u_min, u_max, dt, iter_cnt,
                    zero_out=None):
    """Zalesak sweeps on antisymmetric element flux blocks: flux sums,
    limiting factors, the symmetric limited update (remhos_fct.cpp:344-446).
    """
    du = du_lo
    for _ in range(iter_cnt):
        gp = F.clamp(min=0.0).sum(dim=2)
        gm = F.clamp(max=0.0).sum(dim=2)

        u_lo_new = u + dt * du
        max_pos = ((u_max - u_lo_new) * m).clamp(min=0.0)
        min_neg = ((u_min - u_lo_new) * m).clamp(max=0.0)
        cp = torch.where(gp > max_pos, max_pos / gp, 1.0)
        cn = torch.where(gm < min_neg, min_neg / gm, 1.0)

        aij = torch.where(F >= 0.0,
                          torch.minimum(cp[:, :, None], cn[:, None, :]),
                          torch.minimum(cn[:, :, None], cp[:, None, :]))
        fij = aij * F
        du = du + fij.sum(dim=2) / m / dt
        if zero_out is not None:
            du = zero_out(du)
        F = F - fij
    return du


@spanned("remhos.flux")
def _flux_blocks(geom, bdr_dofs, u, du_ho, dt):
    """F[E, nd, nd] = dt d_ij (u_i - u_j) + dt M_ij (duHO_i - duHO_j), zero
    on the diagonal."""
    Dk = k_ho_diag_blocks(geom["K_elem"], geom["bdrInt"], bdr_dofs)
    dij = torch.maximum((-Dk).clamp(min=0.0), -Dk.transpose(1, 2))
    nd = u.shape[1]
    off = 1.0 - torch.eye(nd, dtype=u.dtype, device=u.device)
    F = dt * dij * (u[:, :, None] - u[:, None, :]) \
        + dt * geom["M"] * (du_ho[:, :, None] - du_ho[:, None, :])
    return F * off, off


def flux_based_fct(adv, geom, u, du_ho, du_lo, u_min, u_max, dt,
                   iter_cnt=1):
    """CalcFCTSolution (remhos_fct.cpp:155-181), iter_cnt = 1 as the driver
    sets it (remhos.cpp:1093): one launch of `ops/fa_fct` where it engages
    (the bounds made contiguous: at -bt 1 they are expanded views), else
    its plain chain."""
    nf, fd = adv.bdr_dofs.shape
    if ffm.engages(u.device, u.dtype, u.shape[1], nf, fd):
        return ffm.fa_fct(geom, u, du_ho, du_lo, u_min.contiguous(),
                          u_max.contiguous(), dt, adv.fa_fct_tables,
                          iter_cnt)
    return ffm.fa_fct_reference(geom, u, du_ho, du_lo, u_min, u_max, dt,
                                adv.bdr_dofs, iter_cnt)


def flux_based_fct_product(adv, geom, us, d_us_HO, d_us_LO, dus_lo_fct,
                           s_min, s_max, us_min, us_max, u_new,
                           active_el, active_dofs, dt, iter_cnt=1):
    """CalcFCTProduct (remhos_fct.cpp:183-262): the product-compatible flux
    blocks, the Zalesak sweeps and the empty-dof zeroing."""
    m = geom["ml"]
    F, off = _flux_blocks(geom, adv.bdr_dofs, us, d_us_HO, dt)

    # product-compatible correction fluxes (remhos_fct.cpp:217-242)
    flux_el = m * dt * (d_us_LO - dus_lo_fct)            # [E, nd]
    beta = m * u_new
    bsum = torch.where(active_el, beta.sum(dim=1), 1.0)
    beta = beta / bsum[:, None]
    A = (beta[:, None, :] * flux_el[:, :, None]
         - beta[:, :, None] * flux_el[:, None, :])       # antisymmetric
    F = F + torch.where(active_el[:, None, None], A, 0.0) * off

    def zero_out(du):
        return syncm.zero_out_empty_dofs(active_el, active_dofs, du)

    return _fct_iterations(F, us, dus_lo_fct, m, us_min, us_max, dt,
                           iter_cnt, zero_out=zero_out)
