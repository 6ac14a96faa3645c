"""Low-order bound-preserving solutions, as vectorized sweeps over [E, nd]:

- `mass_based_avg` (MassBasedAvg, remhos_lo.cpp:247-324; `-lo 5`);
- `residual_distribution_core` with its subcell branch
  (ResidualDistribution, remhos_lo.cpp:102-245; `-lo 3` and `-lo 4`), given
  the matrix-free residual z = K u and the face-lumped accumulator.
"""

from __future__ import annotations

import torch

# guards the weight denominators of an element whose dofs are all equal;
# below float32 round-off, kept as the reference has it
EPS = 1.0e-15


def mass_based_avg(u, du_HO, dt, detJ, w_q, Bu):
    """LO rate: the per-element mass/volume average of the new HO solution
    at the stage-time mesh, du_LO = (avg(u + dt du_HO) - u) / dt."""
    u_new = u + dt * du_HO
    wdet = w_q[None, :] * detJ                    # [E, Q]
    u_q = u_new @ Bu.T                            # [E, Q]
    mass = (wdet * u_q).sum(1)
    vol = wdet.sum(1)
    return ((mass / vol)[:, None] - u) / dt


def residual_distribution_core(u, z, du, ml, subcell=False,
                               subcell_weights=None, sub2ind=None,
                               gamma=1.0):
    """Element-local redistribution of the residual z = K u, weighted by the
    distance to the element's extrema (remhos_lo.cpp:111-245, eqs. 46-47 and
    58-59 of the Hajduk et al. subcell papers), on top of the face-lumped
    accumulator du; returns the LO rate [E, nd].

    subcell_weights: [E, numSubcells, 2^dim] (Assembly::SubcellWeights);
    sub2ind: [numSubcells, 2^dim] long; gamma: the subcell blending factor
    (1.0 in remhos_lo.cpp:118)."""
    nd = u.shape[1]

    xe_max = torch.amax(u, 1)
    xe_min = torch.amin(u, 1)
    x_sum = u.sum(1)
    rhoP = z.clamp(min=0.0).sum(1)
    rhoN = z.clamp(max=0.0).sum(1)
    sumWeightsP = nd * xe_max - x_sum + EPS
    sumWeightsN = nd * xe_min - x_sum - EPS

    weightP = (xe_max[:, None] - u) / sumWeightsP[:, None]
    weightN = (xe_min[:, None] - u) / sumWeightsN[:, None]

    if subcell:
        ndd = sub2ind.shape[1]
        u_sub = u[:, sub2ind]                            # [E, ns, ndd]
        fluct = (subcell_weights * u_sub).sum(-1)        # [E, ns]
        xmax_s = torch.amax(u_sub, -1)
        xmin_s = torch.amin(u_sub, -1)
        xsum_s = u_sub.sum(-1)
        swP = ndd * xmax_s - xsum_s + EPS
        swN = ndd * xmin_s - xsum_s - EPS
        fP = fluct.clamp(min=0.0)
        fN = fluct.clamp(max=0.0)
        sumFP = fP.sum(1)
        sumFN = fN.sum(1)
        # nodal weights: the subcell shares scattered onto the element dofs
        # (eq. 58-59). A dof is a corner of up to 2^dim subcells, so the
        # indices repeat and the shares accumulate.
        nwP_sub = fP[:, :, None] * (xmax_s[:, :, None] - u_sub) \
            / swP[:, :, None]
        nwN_sub = fN[:, :, None] * (xmin_s[:, :, None] - u_sub) \
            / swN[:, :, None]
        E = u.shape[0]
        flat = sub2ind.reshape(-1)
        nwP = torch.zeros_like(u).index_add_(1, flat, nwP_sub.reshape(E, -1))
        nwN = torch.zeros_like(u).index_add_(1, flat, nwN_sub.reshape(E, -1))

        auxP = gamma / (rhoP + EPS)
        weightP = weightP * (1.0 - (auxP * sumFP).clamp(max=1.0))[:, None] \
            + torch.minimum(auxP, 1.0 / (sumFP + EPS))[:, None] * nwP
        auxN = gamma / (rhoN - EPS)
        weightN = weightN * (1.0 - (auxN * sumFN).clamp(max=1.0))[:, None] \
            + torch.maximum(auxN, 1.0 / (sumFN - EPS))[:, None] * nwN

    return (du + weightP * rhoP[:, None] + weightN * rhoN[:, None]) / ml
