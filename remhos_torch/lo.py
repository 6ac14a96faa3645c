"""Low-order bound-preserving solution: MassBasedAvg (`-lo 5`,
remhos_lo.cpp:247-324)."""

from __future__ import annotations


def mass_based_avg(u, du_HO, dt, detJ, w_q, Bu):
    """LO rate: the per-element mass/volume average of the new HO solution
    at the stage-time mesh, du_LO = (avg(u + dt du_HO) - u) / dt."""
    u_new = u + dt * du_HO
    wdet = w_q[None, :] * detJ                    # [E, Q]
    u_q = u_new @ Bu.T                            # [E, Q]
    mass = (wdet * u_q).sum(1)
    vol = wdet.sum(1)
    return ((mass / vol)[:, None] - u) / dt
