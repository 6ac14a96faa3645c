"""Nonlinear-penalty FCT, `-fct 3`: the port of `remhos_tpu.fct_penalty`
(NonlinearPenaltySolver, remhos_fct.cpp:760-996).

The HO update is clipped to the dof bounds, which breaks conservation; the
per-element mass defect is then put back by solving the scalar equation
F(lambda) = delta - sum_j z_j(lambda) = 0 per element. The reference
brackets and bisects element by element; here, as in the JAX package, one
fixed-length bisection runs over all elements at once: F is monotone in
lambda, and 110 halvings reach f64 precision with no data-dependent exit
(about 660 small launches a stage on the card).

The penalty scale eps is element 0's size h/p (remhos_fct.cpp:963), h the
dim-th root of its volume on the stage geometry.

With `-si` the per-dof bounds are first relaxed toward the new HO value
where the solution is smooth (remhos_fct.cpp:779-794, the reference's only
FCT with the smoothness indicator).
"""

from __future__ import annotations

import torch

from .utils.trace import span


def _sum_z(lam, w, fL):
    """(z[E, nd], sum_j z_j): z_j = lambda w_j while |fL_j| >= lambda |w_j|,
    else fL_j (remhos_fct.cpp:824-846); lam[E, 1]."""
    z = torch.where(fL.abs() >= lam * w.abs(), lam * w, fL)
    return z, z.sum(dim=1)


def nonlinear_penalty(adv, geom, u, du_ho, du_lo, u_min, u_max, dt,
                      n_bisect=110):
    m = geom["ml"]
    if adv.cfg.smth_ind:
        with span("remhos.si"):
            si_dof = adv.smth.dof_values(adv.smth.compute(u))
        u_min, u_max = adv.smth.update_bounds(u + dt * du_ho, u_min, u_max,
                                              si_dof)
    # the clipped HO update, from u at the old time (remhos_fct.cpp:796-799)
    du_ho_star = torch.minimum((u_max - u) / dt,
                               torch.maximum(du_ho, (u_min - u) / dt))
    fL = m * (du_ho_star - du_lo)
    fH = m * (du_ho_star - du_ho)

    # the per-element conservation defect
    delta = fL.clamp(min=0.0).sum(dim=1) + fL.clamp(max=0.0).sum(dim=1)

    # penalty weights (remhos_fct.cpp:961-978)
    vol0 = (adv.w_q * geom["detJ"][0]).sum()
    dim = adv.disc.dim
    eps = vol0 ** (1.0 / dim) / adv.disc.p
    maxH = fH.abs().amax(dim=1, keepdim=True)            # [E, 1]
    w_pos = torch.where(fL > 0.0, eps * fL.abs() + maxH, 0.0)
    w_neg = torch.where(fL < 0.0, -eps * fL.abs() - maxH, 0.0)
    w = torch.where((delta > 0.0)[:, None], w_pos, w_neg)

    # batched bisection for lambda: |sum_z| grows monotonically with it
    aw = w.abs()
    pos = aw > 0.0
    lam_hi = torch.where(pos, fL.abs() / torch.where(pos, aw, 1.0),
                         0.0).amax(dim=1, keepdim=True) * 2.0 + 1.0
    lam_lo = torch.zeros_like(lam_hi)
    ad = delta.abs()[:, None]
    for _ in range(n_bisect):
        mid = 0.5 * (lam_lo + lam_hi)
        _, G = _sum_z(mid, w, fL)
        go_right = G.abs()[:, None] < ad
        lam_lo = torch.where(go_right, mid, lam_lo)
        lam_hi = torch.where(go_right, lam_hi, mid)
    z, _ = _sum_z(0.5 * (lam_lo + lam_hi), w, fL)

    # the flux correction -z on elements with a defect
    # (remhos_fct.cpp:980-984)
    fL = fL + torch.where((delta != 0.0)[:, None], -z, 0.0)
    return du_lo + fL / m
