"""FCT limiters that blend du_HO and du_LO per element under per-dof
bounds, conserving lumped mass: ClipScale (`-fct 2`,
remhos_fct.cpp:449-541), the element FCT projection (`-fct 4`,
remhos_fct.cpp:613-731) and the product-field helpers of their solver
families (remhos_fct.cpp:26-153). The flux-based (`-fct 1`) and
nonlinear-penalty (`-fct 3`) limiters are `fct_flux.py` and
`fct_penalty.py`."""

from __future__ import annotations

import torch

from . import assembly as asm
from . import verify as vfy

INF = float("inf")
EPS_PROD = 1.0e-12  # product-bound round-off guard (remhos_fct.cpp:34)
EPS_CS = 1.0e-15   # ClipScale rescale guard (remhos_fct.cpp:486)


def clip_scale(u, m, du_ho, du_lo, u_min, u_max, dt):
    """Clip each element's antidiffusive flux to the dof bounds, then
    rescale it so that its lumped-mass sum is zero."""
    u_new_lo = u + dt * du_lo
    f_min = m / dt * (u_min - u_new_lo)
    f_max = m / dt * (u_max - u_new_lo)
    f = m * (du_ho - du_lo)
    f = torch.minimum(f_max, torch.maximum(f_min, f))

    fpos = f.clamp(min=0.0)
    fneg = f.clamp(max=0.0)
    sum_neg = fneg.sum(dim=1, keepdim=True)
    sum_pos = fpos.sum(dim=1, keepdim=True)
    new_mass = sum_neg + sum_pos
    f = torch.where(new_mass > EPS_CS, fneg - fpos * (sum_neg / sum_pos), f)
    f = torch.where(new_mass < -EPS_CS, fpos - fneg * (sum_pos / sum_neg), f)
    return du_lo + f / m


def element_fct_projection(u, du_HO, du_LO, u_min, u_max, M_elem, dt):
    """Per-element FCT projection with the local consistent mass matrix
    (ElementFCTProjection, remhos_fct.cpp:613-731): antisymmetric pairwise
    fluxes, Zalesak factors against the bounds, one symmetric limited
    update."""
    ML = M_elem.sum(dim=2)                        # row sums
    du_max = (u_max - u) / dt
    du_min = (u_min - u) / dt

    rhs = asm.matvec(M_elem, du_HO)
    beta = ML / ML.sum(dim=1, keepdim=True)
    z = rhs - ML * du_LO

    # F[i, j] = M[i, j] (duHO_i - duHO_j) + (beta_j z_i - beta_i z_j)
    dho = du_HO[:, :, None] - du_HO[:, None, :]
    F = M_elem * dho + (beta[:, None, :] * z[:, :, None]
                        - beta[:, :, None] * z[:, None, :])
    nd = u.shape[1]
    F = F * (1.0 - torch.eye(nd, dtype=u.dtype, device=u.device))

    gp = F.clamp(min=0.0).sum(dim=2)
    gm = F.clamp(max=0.0).sum(dim=2)

    rp = (ML * (du_max - du_LO)).clamp(min=0.0)
    rm = (ML * (du_min - du_LO)).clamp(max=0.0)
    ap = torch.where(rp < gp, rp / gp, 1.0)
    am = torch.where(rm > gm, rm / gm, 1.0)

    # alpha_ij symmetric: min(ap_i, am_j) where F_ij >= 0, else
    # min(am_i, ap_j)
    aij = torch.where(F >= 0.0,
                      torch.minimum(ap[:, :, None], am[:, None, :]),
                      torch.minimum(am[:, :, None], ap[:, None, :]))
    return du_LO + (aij * F).sum(dim=2) / ML


def calc_compatible_lo_product(us, m, d_us_HO, s_min, s_max, u_new,
                               active_el, active_dofs, dt):
    """Compatible LO product update and bound fixes (remhos_fct.cpp:26-119).

    Returns (d_us_LO_new, s_min_fixed, s_max_fixed, s_avg_violations), the
    last being the -vb s_avg stencil-bounds violation count
    (remhos_fct.cpp:84-101); callers ignore it unless verify_bounds is on.
    Elements without an active dof carry smin = +inf, smax = -inf; the
    comparisons against them (and against NaN from inf * 0) are false, which
    leaves those elements untouched."""
    us_new_HO = us + dt * d_us_HO
    act = active_el[:, None]
    mass_us = torch.where(act, us_new_HO * m, 0.0).sum(1)
    mass_u = torch.where(act, u_new * m, 0.0).sum(1)
    safe_mass_u = torch.where(active_el, mass_u, 1.0)
    s_avg = torch.where(active_el, mass_us / safe_mass_u, 0.0)

    smin = torch.where(active_dofs, s_min, INF).amin(1)
    smax = torch.where(active_dofs, s_max, -INF).amax(1)

    # round-off fixes on s_avg (remhos_fct.cpp:78-82)
    s_avg = torch.where((s_avg < smin) & (mass_us + EPS_PROD > smin * mass_u),
                        smin, s_avg)
    s_avg = torch.where((s_avg > smax) & (mass_us - EPS_PROD < smax * mass_u),
                        smax, s_avg)

    # -vb: s_avg must sit in the full active-dof stencil bounds after the
    # round-off fixes (remhos_fct.cpp:84-101)
    has_active = active_dofs.any(dim=1)
    viol = vfy.check_s_avg(mass_us, mass_u, s_avg, smin, smax,
                           active_el & has_active)

    # widen local dof bounds to include s_avg (remhos_fct.cpp:103-106)
    sa = s_avg[:, None]
    widen = act & active_dofs
    s_min = torch.where(widen & (sa + EPS_PROD < s_min), sa, s_min)
    s_max = torch.where(widen & (sa - EPS_PROD > s_max), sa, s_max)

    d_us_LO_new = torch.where(act, (u_new * sa - us) / dt, 0.0)
    return d_us_LO_new, s_min, s_max, viol


def scale_product_bounds(s_min, s_max, u_new, active_el, active_dofs):
    """(us_min, us_max) = (s_min*u_new, s_max*u_new) on active dofs
    (remhos_fct.cpp:121-153)."""
    act = active_el[:, None] & active_dofs
    return (torch.where(act, s_min * u_new, 0.0),
            torch.where(act, s_max * u_new, 0.0))
