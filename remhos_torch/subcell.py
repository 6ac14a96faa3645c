"""Subcell weights of the Bernstein subcell residual-distribution scheme
(`-lo 4`, `-mono 2`): the port of `remhos_tpu.subcell`.

The reference builds a p-times-refined "subcell mesh" whose Q1 cells connect
the Bernstein control points (remhos.cpp:797-832) and integrates one-row
convection matrices per subcell with a midpoint rule
(Assembly::ComputeSubcellWeights, remhos_tools.cpp:860-874, 1033-1076):

    w[e, m, j] = sign * (adj(J_c) v_c) . grad(psi_j)(center)

with psi the Q1 basis on subcell m, J_c its Jacobian at the centre and v_c
the velocity there. On a tensor grid the subcell corners are the element's
closed-uniform nodes, so all of it is batched index arithmetic over
`sub2ind`.

In remap mode the subcell mesh moves with its OWN nodal velocity: the raw
velocity function at the subcell nodes, zeroed on the domain boundary
(remhos.cpp:838-852), not the integrated mesh velocity; the positions are
x_sub = x0_sub + t * v_sub (remhos.cpp:1605). In transport mode the subcell
mesh stands still, the velocity is the problem's at each subcell's centre and
the weights take the sign -1.
"""

from __future__ import annotations

import numpy as np
import torch

from . import problems as prob
from .dofmaps import face_dof_table
from .geometry import det_adj


def q1_center_grads(dim: int) -> np.ndarray:
    """grad(psi_j) at the reference centre, corners in lexicographic order:
    [2^dim, dim]; component d is (+-1) * (1/2)^(dim-1)."""
    idx = np.arange(2 ** dim)
    bits = np.stack([(idx >> d) & 1 for d in range(dim)], axis=-1)
    return np.where(bits == 1, 1.0, -1.0) * 0.5 ** (dim - 1)


def boundary_node_mask(mesh, ref_nodes_u) -> np.ndarray:
    """[E, nd] True where the (uniform) node lies on a physical,
    non-periodic boundary: the reference zeroes the subcell velocity there
    (remhos.cpp:841-852). On a general mesh, the nodes of the faces without
    a neighbour; on a structured one, the reference coordinates 0 and 1
    (exact in `ref_nodes_u`, linspace end points) of the elements at a
    non-periodic end of an axis."""
    E = mesh.num_elements
    if not getattr(mesh, "structured", True):
        nd = ref_nodes_u.shape[0]
        bdr = face_dof_table(round(nd ** (1.0 / mesh.dim)) - 1, mesh.dim)
        mask = np.zeros((E, nd), dtype=bool)
        for f in range(mesh.nfaces):
            mask[np.ix_(mesh.nbr_elem[:, f] < 0, bdr[f])] = True
        return mask
    eidx = np.stack(np.unravel_index(np.arange(E), mesh.shape, order="F"),
                    axis=-1)
    mask = np.zeros((E, ref_nodes_u.shape[0]), dtype=bool)
    for d in range(mesh.dim):
        if mesh.periodic[d]:
            continue
        on_lo = (eidx[:, d] == 0)[:, None] & (ref_nodes_u[None, :, d] == 0.0)
        on_hi = (eidx[:, d] == mesh.shape[d] - 1)[:, None] & \
                (ref_nodes_u[None, :, d] == 1.0)
        mask |= on_lo | on_hi
    return mask


def subcell_node_setup(adv):
    """(x0_sub[E, nd, dim], v_sub[E, nd, dim] or None) of an `Advection`,
    in its working dtype on its device; v_sub is None in transport mode."""
    disc = adv.disc
    dtype, device = adv.dtype, adv.device
    Bm_at_u = torch.as_tensor(disc.Bm_at_unodes, dtype=dtype, device=device)
    x0_sub = torch.einsum("end,mn->emd", adv.x0_nodes, Bm_at_u)
    if adv.cfg.exec_mode != 1:
        return x0_sub, None
    v = prob.velocity_function(adv.cfg.problem, x0_sub, adv.bb_min,
                               adv.bb_max)
    # a shard's operator pre-sets the mask made in GLOBAL context: its
    # interface to the next shard is not a physical boundary
    mask = getattr(adv, "_sub_bmask", None)
    if mask is None:
        mask = boundary_node_mask(disc.mesh, disc.ref_nodes_u)
    mask = torch.as_tensor(mask, device=device)
    return x0_sub, torch.where(mask[:, :, None], 0.0, v)


def subcell_weights(adv, t):
    """SubcellWeights[E, numSubcells, 2^dim] at the stage time t. Remap:
    sign +1, the Q1 velocity at the centre is the corner average.
    Transport: sign -1, the velocity function at the corners' mean,
    evaluated in f64 and cast to the working dtype as the JAX package
    does."""
    x0_sub, v_sub = adv._subcell_nodes
    sub2ind, Gc = adv._sub2ind, adv._q1_grads      # [ns, 2^d], [2^d, dim]
    xs = x0_sub if v_sub is None else x0_sub + t * v_sub
    corners = xs[:, sub2ind]                        # [E, ns, 2^d, dim]
    nc, dim = Gc.shape
    J_c = (corners.transpose(-1, -2).reshape(-1, nc) @ Gc).reshape(
        corners.shape[:2] + (dim, dim))             # one GEMM, not a bmm
    _, adj = det_adj(J_c)
    if v_sub is None:
        v_c = prob.velocity_function(
            adv.cfg.problem, corners.mean(dim=2).double(), adv.bb_min,
            adv.bb_max).to(xs.dtype)
    else:
        v_c = v_sub[:, sub2ind].mean(dim=2)         # [E, ns, dim]
    av = (v_c[:, :, None, :] * adj).sum(-1)        # adj J v (row form)
    w = av @ Gc.T
    return w if v_sub is not None else -w
