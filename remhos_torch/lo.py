"""Low-order bound-preserving solutions, as vectorized sweeps over [E, nd]:

- `mass_based_avg` (MassBasedAvg, remhos_lo.cpp:247-324; `-lo 5`);
- `residual_distribution_core` with its subcell branch
  (ResidualDistribution, remhos_lo.cpp:102-245; `-lo 3` and `-lo 4`), given
  the residual z = K u and the face-lumped accumulator; the assembled path's
  `residual_distribution` forms both from K_elem and bdrInt;
- `discrete_upwind` (DiscreteUpwind, remhos_lo.cpp:31-100; `-lo 1`, and
  `-lo 2` on the preconditioned convection matrix): the reference's sparse K
  is block-diagonal (its `k` form has only a domain integrator), so D is
  built on dense element blocks. Assembled path only, as in the reference.
"""

from __future__ import annotations

import torch

from . import assembly as asm
from .ho import mass_cholesky

# guards the weight denominators of an element whose dofs are all equal
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
    xe_max = torch.amax(u, 1)
    xe_min = torch.amin(u, 1)
    rhoP = z.clamp(min=0.0).sum(1)
    rhoN = z.clamp(max=0.0).sum(1)
    # each weight's normaliser is the sum of its own numerators, equal in
    # exact arithmetic to the reference's nd*x_max - sum(u) (remhos_lo.cpp:
    # 130-131); that form cancels to EPS in f32 on a nearly constant
    # element while the numerators do not, and the weights then sum far
    # above 1 (mass lost, bounds broken)
    numP = xe_max[:, None] - u
    numN = xe_min[:, None] - u
    weightP = numP / (numP.sum(1) + EPS)[:, None]
    weightN = numN / (numN.sum(1) - EPS)[:, None]

    if subcell:
        u_sub = u[:, sub2ind]                            # [E, ns, ndd]
        fluct = (subcell_weights * u_sub).sum(-1)        # [E, ns]
        nsP = torch.amax(u_sub, -1, keepdim=True) - u_sub   # [E, ns, ndd]
        nsN = torch.amin(u_sub, -1, keepdim=True) - u_sub
        swP = nsP.sum(-1) + EPS
        swN = nsN.sum(-1) - EPS
        fP = fluct.clamp(min=0.0)
        fN = fluct.clamp(max=0.0)
        sumFP = fP.sum(1)
        sumFN = fN.sum(1)
        # nodal weights: the subcell shares scattered onto the element dofs
        # (eq. 58-59). A dof is a corner of up to 2^dim subcells, so the
        # indices repeat and the shares accumulate.
        nwP_sub = fP[:, :, None] * nsP / swP[:, :, None]
        nwN_sub = fN[:, :, None] * nsN / swN[:, :, None]
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


def _face_lumped_into_dofs(u, u_nbr, bdrInt, bdr_dofs):
    """LinearFluxLumping(alpha = 0) accumulated into the element dofs."""
    contrib = asm.face_term_lumped(asm.gather_face(u, bdr_dofs), u_nbr,
                                   bdrInt)
    return asm.scatter_face_add(torch.zeros_like(u), contrib, bdr_dofs)


def residual_distribution(u, u_nbr, K_elem, bdrInt, ml, bdr_dofs,
                          subcell=False, subcell_weights=None, sub2ind=None):
    """The assembled residual distribution: z = K_elem u and the lumped face
    terms, then `residual_distribution_core`."""
    return residual_distribution_core(
        u, asm.matvec(K_elem, u),
        _face_lumped_into_dofs(u, u_nbr, bdrInt, bdr_dofs), ml, subcell,
        subcell_weights, sub2ind)


def precond_convection_matrix(K_elem, M_elem):
    """PrecondConvectionIntegrator's element matrix ML M^-1 K
    (remhos_tools.cpp:975-1031; ML the lumped element mass), for `-lo 2`."""
    L = mass_cholesky(M_elem)
    Y = torch.linalg.solve_triangular(L, K_elem, upper=False)
    MinvK = torch.linalg.solve_triangular(L.transpose(1, 2), Y, upper=True)
    return M_elem.sum(dim=2)[:, :, None] * MinvK


def discrete_upwind_matrix(K_elem):
    """D[E, nd, nd] = K + d, d_ij = max(0, -k_ij, -k_ji) off the diagonal and
    minus its row sums on it, so that the rows of d sum to zero
    (remhos_lo.cpp:76-100)."""
    nd = K_elem.shape[-1]
    d = torch.maximum((-K_elem).clamp(min=0.0), -K_elem.transpose(1, 2))
    off = 1.0 - torch.eye(nd, dtype=K_elem.dtype, device=K_elem.device)
    d_off = d * off
    return K_elem + d_off - (1.0 - off) * d_off.sum(2)[:, :, None]


def discrete_upwind(u, u_nbr, D, bdrInt, ml, bdr_dofs):
    """du = (D u + the lumped face fluxes) / ml (remhos_lo.cpp:43-74)."""
    du = asm.matvec(D, u) + _face_lumped_into_dofs(u, u_nbr, bdrInt,
                                                    bdr_dofs)
    return du / ml
