"""Geometric factors of moving tensor meshes, as batched torch products.

The port's copy of `remhos_tpu.geometry`, for 1D, 2D and 3D meshes.
Conventions: mesh nodes x[E, nm, dim] (lexicographic Gauss-Lobatto nodes),
Jacobian J[e, q, a, b] = d x_a / d xi_b, held as per-entry planes
J[d][b] -> [E, Q].
"""

from __future__ import annotations

import numpy as np
import torch


def _nodes_matrix(x):
    """x[E, nm, dim] -> [E*dim, nm] for one contraction over nodes."""
    E, nm, dim = x.shape
    return x.transpose(1, 2).reshape(E * dim, nm), E, dim


def interp_nodes(x, Bt):
    """Interpolate a nodal field at points: Bt[P, nm] -> [E, P, dim]."""
    A, E, dim = _nodes_matrix(x)
    return (A @ Bt.T).reshape(E, dim, -1).transpose(1, 2)


def face_velocity(v, Bmf):
    """The nodal velocity v at the face points [E, nf, Qf, dim], from the
    mesh basis there, Bmf[nf, Qf, nm]. In remap it does not depend on time,
    so the operator makes it once (the reference reassembles it every
    stage, remhos.cpp:1612-1643)."""
    nf, Qf, nm = Bmf.shape
    return interp_nodes(v, Bmf.reshape(nf * Qf, nm)).reshape(
        v.shape[0], nf, Qf, -1)


def jacobian_planes(x, Gm):
    """Jacobian planes J[d][b] -> [E, Q] from nodes x and Gm[Q, nm, dim]."""
    A, E, dim = _nodes_matrix(x)
    cols = [(A @ Gm[:, :, b].T).reshape(E, dim, -1) for b in range(dim)]
    return [[cols[b][:, d, :] for b in range(dim)] for d in range(dim)]


def volume_detj(x, Gm):
    """det J[E, Q] at the volume rule (the cofactor-column form of
    `remhos_tpu.geometry.volume_detj_va`)."""
    Jp = jacobian_planes(x, Gm)
    if x.shape[-1] == 2:
        return Jp[0][0] * Jp[1][1] - Jp[0][1] * Jp[1][0]
    k0 = [Jp[(d + 1) % 3][1] * Jp[(d + 2) % 3][2]
          - Jp[(d + 1) % 3][2] * Jp[(d + 2) % 3][1] for d in range(3)]
    return sum(Jp[d][0] * k0[d] for d in range(3))


def jacobians(x, Gm):
    """J[E, Q, dim, dim] from nodes x[E, nm, dim] and Gm[Q, nm, dim]."""
    Jp = jacobian_planes(x, Gm)
    return torch.stack([torch.stack(row, -1) for row in Jp], -2)


def volume_geometry(x, Bm, Gm):
    """The volume rule's geometry: x_q[E, Q, dim], detJ[E, Q] and
    adjJ[E, Q, dim, dim]."""
    det, adj = det_adj(jacobians(x, Gm))
    return {"x_q": interp_nodes(x, Bm), "detJ": det, "adjJ": adj}


def det_adj(J):
    """(det J[...], adj J[..., dim, dim]) of J[..., dim, dim] in closed
    form, no linear solves; adj(J) = det(J) J^-1 is the transposed cofactor
    matrix (in 1D the 1x1 identity)."""
    if J.shape[-1] == 1:
        return J[..., 0, 0], torch.ones_like(J)
    if J.shape[-1] == 2:
        a, b = J[..., 0, 0], J[..., 0, 1]
        c, d = J[..., 1, 0], J[..., 1, 1]
        adj = torch.stack([torch.stack([d, -b], -1),
                           torch.stack([-c, a], -1)], -2)
        return a * d - b * c, adj
    c00 = J[..., 1, 1] * J[..., 2, 2] - J[..., 1, 2] * J[..., 2, 1]
    c01 = J[..., 1, 2] * J[..., 2, 0] - J[..., 1, 0] * J[..., 2, 2]
    c02 = J[..., 1, 0] * J[..., 2, 1] - J[..., 1, 1] * J[..., 2, 0]
    c10 = J[..., 0, 2] * J[..., 2, 1] - J[..., 0, 1] * J[..., 2, 2]
    c11 = J[..., 0, 0] * J[..., 2, 2] - J[..., 0, 2] * J[..., 2, 0]
    c12 = J[..., 0, 1] * J[..., 2, 0] - J[..., 0, 0] * J[..., 2, 1]
    c20 = J[..., 0, 1] * J[..., 1, 2] - J[..., 0, 2] * J[..., 1, 1]
    c21 = J[..., 0, 2] * J[..., 1, 0] - J[..., 0, 0] * J[..., 1, 2]
    c22 = J[..., 0, 0] * J[..., 1, 1] - J[..., 0, 1] * J[..., 1, 0]
    det = J[..., 0, 0] * c00 + J[..., 0, 1] * c01 + J[..., 0, 2] * c02
    adj = torch.stack([torch.stack([c00, c10, c20], -1),
                       torch.stack([c01, c11, c21], -1),
                       torch.stack([c02, c12, c22], -1)], -2)
    return det, adj


def face_geometry(x, Bmf, Gmf, n_ref):
    """The face points x_fq[E, nf, Qf, dim] and the scaled outward normals
    nor[E, nf, Qf, dim] by Nanson's formula, n = adj(J)^T n_ref, from the
    full face Jacobians: Bmf[nf, Qf, nm], Gmf[nf, Qf, nm, dim], n_ref[nf,
    dim]. The route where `face_tangent_tables` gives None (1D)."""
    A, E, dim = _nodes_matrix(x)
    nf, Qf, nm = Bmf.shape
    x_fq = (A @ Bmf.permute(2, 0, 1).reshape(nm, nf * Qf)).reshape(
        E, dim, nf, Qf).permute(0, 2, 3, 1)
    J = (A @ Gmf.permute(2, 0, 1, 3).reshape(nm, nf * Qf * dim)).reshape(
        E, dim, nf, Qf, dim).permute(0, 2, 3, 1, 4)
    _, adj = det_adj(J)
    # (adj^T n_ref)_b = sum_d adj[d, b] n_ref[d], elementwise and summed
    nor = (adj * n_ref[None, :, None, :, None]).sum(-2)
    return x_fq, nor


def volume_detj_va(x, Gm, v_q, sign):
    """(det J[E, Q], va[E, Q, 1]) of a 1D mesh for the matrix-free
    convection action: det J = dx/dxi and va = sign * adj(J) v = sign * v
    (remhos_tpu/geometry.py:158-167). In 2D and 3D the stage kernels
    (kernels 3 and 4) form both from the nodes."""
    if x.shape[-1] != 1:
        raise ValueError("volume_detj_va is the 1D route; 2D and 3D take "
                         "the wdet and geom_conv kernels")
    return jacobian_planes(x, Gm)[0][0], sign * v_q


def face_tangent_tables(Gmf, n_ref):
    """Tangent-only face-normal tables (host numpy).

    A tensor element's reference normals are +-e_k, so the Nanson normal
    adj(J)^T n_ref is +-(column k of cof(J)): the cross product of the other
    (tangential) Jacobian columns in 3D, a rotated column in 2D. Returns
    (Gmf_tan[nf, Qf, nm, dim-1], sign[nf]), or None in 1D (a point face
    has no tangent) and when a reference normal is not axis-aligned; the
    normals then come from `face_geometry`."""
    Gmf = np.asarray(Gmf)
    n_ref = np.asarray(n_ref)
    dim = Gmf.shape[3]
    if dim == 1:
        return None
    k = np.abs(n_ref).argmax(axis=1)
    s = np.take_along_axis(n_ref, k[:, None], 1)[:, 0]
    if not np.allclose(np.abs(n_ref).sum(1), np.abs(s)):
        return None
    if dim == 3:
        t_axes = np.stack([(k + 1) % 3, (k + 2) % 3], axis=1)
    else:
        t_axes = (1 - k)[:, None]
        s = s * np.where(k == 0, 1.0, -1.0)
    Gt = np.take_along_axis(Gmf, t_axes[:, None, None, :], axis=3)
    return Gt, s


def face_normals_tangent(x, Gmf_tan, sign):
    """Scaled outward face normals nor[E, nf, Qf, dim] (|nor| = surface
    Jacobian) from the tangential Jacobian columns alone: Gmf_tan[nf, Qf,
    nm, dim-1] and sign[nf] of `face_tangent_tables`. The remap stage needs
    no face points: its face velocity does not depend on time."""
    A, E, dim = _nodes_matrix(x)
    nf, Qf, nm, tdim = Gmf_tan.shape
    G2 = Gmf_tan.permute(2, 0, 1, 3).reshape(nm, nf * Qf * tdim)
    T = (A @ G2).reshape(E, dim, nf, Qf, tdim).permute(0, 2, 3, 1, 4)
    if dim == 3:
        nor = torch.linalg.cross(T[..., 0], T[..., 1], dim=-1)
    else:
        t = T[..., 0]
        nor = torch.stack([t[..., 1], -t[..., 0]], -1)
    return nor * sign[None, :, None, None]


def face_geometry_tangent(x, Bmf, Gmf_tan, sign):
    """The face points x_fq[E, nf, Qf, dim] and the scaled outward normals
    of `face_normals_tangent` there."""
    A, E, dim = _nodes_matrix(x)
    nf, Qf, nm = Bmf.shape
    x_fq = (A @ Bmf.permute(2, 0, 1).reshape(nm, nf * Qf)).reshape(
        E, dim, nf, Qf).permute(0, 2, 3, 1)
    return x_fq, face_normals_tangent(x, Gmf_tan, sign)


def lumped_mass_poly(x0, v, disc):
    """Lumped mass as a polynomial in pseudotime, ml(t) = sum_k t^k ml_k.

    The remap mesh moves linearly, x(t) = x0 + t*v, so det J(t) has degree
    `dim` and ml_i(t) = sum_q Bu[q, i] w_q det_q(t) inherits its
    coefficients. Returns (mlk[dim+1, E, nd], sig[dim+1]) with
    sig_k = sum_i mlk[k, i], all in float64 on the device of x0."""
    x0 = torch.as_tensor(x0).to(torch.float64)
    v = torch.as_tensor(v).to(device=x0.device, dtype=torch.float64)
    Gm = torch.as_tensor(disc.Gm, dtype=torch.float64, device=x0.device)
    dim = x0.shape[-1]
    J0 = jacobian_planes(x0, Gm)
    Jv = jacobian_planes(v, Gm)

    def prod2(a, b):
        """(a0 + t a1)(b0 + t b1) coefficients."""
        return (a[0] * b[0], a[0] * b[1] + a[1] * b[0], a[1] * b[1])

    def pair(d, b):
        return (J0[d][b], Jv[d][b])

    if dim == 1:
        det_c = pair(0, 0)
    elif dim == 2:
        p1 = prod2(pair(0, 0), pair(1, 1))
        p2 = prod2(pair(0, 1), pair(1, 0))
        det_c = tuple(a - b for a, b in zip(p1, p2))
    else:
        det_c = None
        for b in range(3):
            b1, b2 = (b + 1) % 3, (b + 2) % 3
            c1 = prod2(pair(1, b1), pair(2, b2))
            c2 = prod2(pair(1, b2), pair(2, b1))
            cof = tuple(a - bb for a, bb in zip(c1, c2))
            j0, j1 = pair(0, b)
            term = (j0 * cof[0], j0 * cof[1] + j1 * cof[0],
                    j0 * cof[2] + j1 * cof[1], j1 * cof[2])
            det_c = term if det_c is None else tuple(
                p + q for p, q in zip(det_c, term))

    w_q = torch.as_tensor(disc.w_q, dtype=torch.float64, device=x0.device)
    Bu = torch.as_tensor(disc.Bu, dtype=torch.float64, device=x0.device)
    mlk = torch.stack([(w_q[None, :] * dk) @ Bu for dk in det_c])
    return mlk, mlk.sum(dim=(1, 2))
