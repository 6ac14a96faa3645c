"""Per-element extrema for the FCT bounds (remhos_tools.cpp:497-523)."""

from __future__ import annotations


def elements_min_max(u):
    """(el_min[E], el_max[E]) over each element's Bernstein dofs, which
    bound the element's polynomial."""
    return u.amin(dim=1), u.amax(dim=1)
