"""Per-element extrema for the FCT bounds (remhos_tools.cpp:497-523).

`active_el` / `active_dof` masks support product-field remap, where empty
elements must not affect the bounds (remhos.cpp:1889-1892)."""

from __future__ import annotations

import torch

INF = float("inf")


def elements_min_max(u, active_el=None, active_dof=None):
    """(el_min[E], el_max[E]) over each element's Bernstein dofs, which
    bound the element's polynomial. Inactive dofs and elements read +inf
    (min) and -inf (max)."""
    lo, hi = u, u
    if active_dof is not None:
        lo = torch.where(active_dof, u, INF)
        hi = torch.where(active_dof, u, -INF)
    el_min, el_max = lo.amin(dim=1), hi.amax(dim=1)
    if active_el is not None:
        el_min = torch.where(active_el, el_min, INF)
        el_max = torch.where(active_el, el_max, -INF)
    return el_min, el_max
