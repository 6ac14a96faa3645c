"""The monolithic RD solver's constants and its plain nonlinear flux lumping
(NonlinFluxLumping, remhos_tools.cpp:915-973), shared by the solver
(`mono.py`) and its explicit-part kernel's plain chain (`ops/mono_rd.py`).
`csrc/mono_rd.cu` holds EPS and BETA as compile-time constants too."""

from __future__ import annotations

import torch

EPS = 1.0e-15
GAMMA = 10.0
BETA = 10.0


def _rescale(c, sp, sn):
    """The conservation rescaling of remhos_tools.cpp:945-968 and
    remhos_mono.cpp:318-336: with positive and negative sums sp and sn, the
    larger side is scaled down so that the parts cancel."""
    tot = sp + sn
    cp, cn = c.clamp(min=0.0), c.clamp(max=0.0)
    return torch.where(
        tot > EPS, cn - cp * (sn / torch.where(sp != 0, sp, 1.0)),
        torch.where(tot < -EPS, cp - cn * (sp / torch.where(sn != 0, sn,
                                                              1.0)), c))


def nonlin_flux_lumping(u_face, u_nbr, bdrInt, alpha_face):
    """NonlinFluxLumping (remhos_tools.cpp:915-973): the lumped face term
    plus a per-face conservation-rescaled high-order correction,
    [E, nf, fd]."""
    xd = u_nbr - u_face
    row = bdrInt.sum(dim=3)
    lumped = row * xd
    corr = ((bdrInt * xd[:, :, None, :]).sum(-1) - row * xd) * alpha_face
    sp = corr.clamp(min=0.0).sum(dim=2, keepdim=True)
    sn = corr.clamp(max=0.0).sum(dim=2, keepdim=True)
    return lumped + _rescale(corr, sp, sn)
