"""FCT limiter: ClipScale (`-fct 2`, remhos_fct.cpp:449-541)."""

from __future__ import annotations

import torch

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
