"""The benchmark's one generator of inputs: the initial fields of a phase.

A cell's file gives the parameters; the seed draws only where each feature
sits, so every seed asks the same work of the program (the same mesh, the
same number of steps, features of the same sizes and heights):

- `bumps`: [[radius, height], ...], smooth cos^2 bumps of compact support;
- `boxes`: [[half width, height], ...], axis-aligned boxes with sharp edges;
- `margin`: centres are drawn uniformly in [margin, 1 - margin]^dim.

The field is the largest of the features at each point (so it stays in
[0, 1], the range of a volume fraction, and is 0 away from them), taken at
the closed-uniform points whose values are the Bernstein coefficients of
its projection (MFEM's PositiveFiniteElement::Project). With `product` (the
configuration's `-ps`), a
second field us = u s carries Remhos's product ratio s = 2 + sin(2 pi x)
sin(2 pi y) (remhos.cpp:2357-2361) on the elements where u is active. Both
fields are rounded to float32 first, so the program (float32) and the
reference (float64) start from the same numbers.
"""

from __future__ import annotations

import math

import numpy as np
import torch

ACTIVE_TOL = 1e-12


def initial_fields(points, traffic, seed, product=False):
    """S0[nfields, E, nd] (float64 values that float32 holds exactly) at the
    Bernstein points[E, nd, dim]."""
    dim, m = points.shape[-1], traffic["margin"]
    rng = np.random.default_rng(seed % 2 ** 64)
    centres = {k: rng.uniform(m, 1.0 - m, size=(len(traffic[k]), dim))
               for k in ("bumps", "boxes")}
    u = torch.zeros(points.shape[:-1], dtype=torch.float64,
                    device=points.device)
    for (radius, height), c in zip(traffic["bumps"], centres["bumps"]):
        r = (points - points.new_tensor(c)).norm(dim=-1)
        bump = torch.cos(0.5 * math.pi * r / radius) ** 2
        u = torch.maximum(u, torch.where(r < radius, height * bump, 0.0))
    for (half, height), c in zip(traffic["boxes"], centres["boxes"]):
        inside = ((points - points.new_tensor(c)).abs() < half).all(-1)
        u = torch.maximum(u, torch.where(inside, height, 0.0))
    u = u.float().double()
    if not product:
        return u[None]
    s = 2.0 + (torch.sin(2 * math.pi * points[..., 0])
               * torch.sin(2 * math.pi * points[..., 1]))
    active = (u > ACTIVE_TOL).any(1, keepdim=True)
    us = torch.where(active, u * s, 0.0).float().double()
    return torch.stack([u, us])
