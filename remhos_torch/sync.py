"""Product-field synchronization utilities (us = u*s, multi-material remap).

The port of `remhos_tpu.sync` (remhos_sync.cpp): boolean activity
indicators, the ratio s = us/u with inactive-dof fill, and empty-dof
zeroing. All masked vector ops over [E, nd]; `torch.where` evaluates both
sides, and the fills keep every division finite.
"""

from __future__ import annotations

import torch

EMPTY_ZONE_TOL = 1e-12  # remhos_sync.hpp:20
INF = float("inf")


def bool_indicators(u):
    """(active_el[E], active_dofs[E, nd]) (remhos_sync.cpp:24-47)."""
    active_dofs = u > EMPTY_ZONE_TOL
    return active_dofs.any(dim=1), active_dofs


def compute_ratio(us, u):
    """s = us/u on active dofs; element-average ratio elsewhere; 0 in empty
    elements (remhos_sync.cpp:50-94). Returns (s, active_el, active_dofs)."""
    active_el, active_dofs = bool_indicators(u)
    ratio = us / torch.where(active_dofs, u, 1.0)
    n = active_dofs.sum(dim=1)
    s_avg = torch.where(active_dofs, ratio, 0.0).sum(dim=1) / n.clamp(min=1)
    s = torch.where(active_dofs, ratio, s_avg[:, None])
    s = torch.where(active_el[:, None], s, 0.0)
    return s, active_el, active_dofs


def zero_out_empty_dofs(active_el, active_dofs, u):
    """Zero u at inactive dofs of inactive elements
    (remhos_sync.cpp:96-114)."""
    return torch.where(active_el[:, None] | active_dofs, u, 0.0)


def min_max_s(us, u):
    """Global (min s, max s) over active dofs (remhos_sync.cpp:116-140)."""
    s, _, active_dofs = compute_ratio(us, u)
    return (torch.where(active_dofs, s, INF).min(),
            torch.where(active_dofs, s, -INF).max())
