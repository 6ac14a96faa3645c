"""Partial-assembly (matrix-free) operator actions: the subset the fused
remap stage uses (`remhos_tpu.pa.lumped_mass_pa`). The other actions belong
to the non-fused PA path (ROADMAP.md Queue 1, item 9 and Queue 2, item 4)."""

from __future__ import annotations


def lumped_mass_pa(wdet, Bu):
    """ml = M.1 = Bu^T (w det J): Bernstein is a partition of unity."""
    return wdet @ Bu
