"""Setup-time tables of the mega stage kernel (torch, not kernels).

Counterparts of `stage_ho_tables` and `build_poly_tables` in
`remhos_tpu/ops/pallas_kernels.py`, in the port's own layout:

- No padding. The TPU pads every quadrature segment to S = 256 lanes; here
  each segment has its natural length (Q = 216 volume points and FQ = 216
  face points at p=3 in 3D), which shrinks the dominant P stream by 16%.
- The face tables stay per face ([Qf, fd]) instead of block-diagonal
  [nf*fd, nf*Qf] matrices; the kernel indexes faces through `bdr`.
- The one-hot class->dof expansion matrix becomes `cls[nd]`, the class of
  each dof, and the stencil expansion is an index lookup.

Every dense table is stored input-index-major ([K, L] for an L-long output
contracted over K), which is the order the kernel reads it in.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import geometry as geo


def poly_layout(dim, Q, FQ):
    """Segment offsets of P = [VA | WDET | VN] per element.

    VA holds nkv*dim segments of length Q (segment k*dim + b: the t^k
    coefficient of va_b), WDET nkd segments of length Q (w_q det J), VN nkn
    segments of length FQ (the upwind normal velocity). nkv = nkn = dim and
    nkd = dim + 1: the degrees in t of the cofactors and of det J."""
    nkv, nkd, nkn = dim, dim + 1, dim
    va, wd = 0, nkv * dim * Q
    vn = wd + nkd * Q
    return dict(nkv=nkv, nkd=nkd, nkn=nkn, va=va, wdet=wd, vn=vn,
                width=vn + nkn * FQ)


def class_of_dofs(nd, dim):
    """cls[nd]: bounds class of each dof, cz*9 + cy*3 + cx, where per axis
    a dof is class 0 (low GLL endpoint), 1 (interior) or 2 (high end)."""
    n1 = round(nd ** (1.0 / dim))
    cls = np.zeros(nd, dtype=np.int32)
    for i in range(nd):
        c = 0
        for a in reversed(range(dim)):
            k = (i // n1 ** a) % n1
            c = c * 3 + (0 if k == 0 else (2 if k == n1 - 1 else 1))
        cls[i] = c
    return cls


def _dof_faces(bdr, nd, dim):
    """dof_faces[nd, dim]: flat face-dof slots f*fd + i with bdr[f, i] == j
    (a dof lies on at most dim faces), padded with -1."""
    out = -np.ones((nd, dim), dtype=np.int32)
    fill = np.zeros(nd, dtype=np.int32)
    nf, fd = bdr.shape
    for f in range(nf):
        for i in range(fd):
            j = bdr[f, i]
            out[j, fill[j]] = f * fd + i
            fill[j] += 1
    return out


def stage_ho_tables(disc, dtype, device):
    """Static tables of the mega stage (built once per Advection)."""
    dim, nd, fd = disc.dim, disc.nd, disc.fd
    Q = len(disc.w_q)
    Qf = disc.Bface.shape[0]
    nf = disc.n_ref.shape[0]
    bdr = np.asarray(disc.dofmaps.bdr_dofs, dtype=np.int32)
    Gu = np.asarray(disc.Gu)
    GuT = np.concatenate([Gu[:, :, b].T for b in range(dim)], axis=1)
    Bu = np.asarray(disc.Bu)
    Bgl = np.asarray(disc.Bgl)
    A = np.asarray(disc.A_gl2b)

    def F(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=device)

    def I(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=torch.int32,
                               device=device)

    return dict(
        GuT=F(GuT),                                  # [nd, dim*Q]
        Buw=F(Bu * np.asarray(disc.w_q)[:, None]),   # [Q, nd]
        Bface=F(disc.Bface),                         # [Qf, fd]
        SBf=F(np.asarray(disc.w_fq)[:, None] * disc.Bface),  # [Qf, fd]
        A=F(A), AT=F(A.T),                           # [nd, nd]
        BglT=F(Bgl.T), Bgl=F(Bgl), Bgl2=F(Bgl * Bgl),
        Bu=F(Bu), w_q=F(disc.w_q),
        bdr=I(bdr),                                  # [nf, fd]
        dof_faces=I(_dof_faces(bdr, nd, dim)),       # [nd, dim]
        cls=I(class_of_dofs(nd, dim)),              # [nd]
        dim=dim, nd=nd, Q=Q, Qf=Qf, nf=nf, fd=fd)


def build_poly_tables(x0, v, disc):
    """P[E, width]: the t-polynomial coefficients of the stage geometry.

    In remap the mesh moves linearly, J(t) = J0 + t Jv, so the convective
    velocity va_b = v . cof(J)[:, b], w_q det J and the face normal velocity
    vn = v . n are polynomials in t whose coefficients are computed once
    here; the stage kernel evaluates them by Horner's rule. Computed in the
    dtype of x0 (layout: `poly_layout`)."""
    dtype, device = x0.dtype, x0.device
    dim = disc.dim
    E = x0.shape[0]
    Gm = np.asarray(disc.Gm, np.float64)
    Q, nm = Gm.shape[0], Gm.shape[1]
    nf = disc.n_ref.shape[0]
    Qf = disc.Bface.shape[0]
    FQ = nf * Qf

    def T(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=device)

    x0_t = x0.permute(2, 0, 1)                             # [dim, E, nm]
    v_t = v.to(dtype).permute(2, 0, 1)
    Gmb = [T(Gm[:, :, b].T) for b in range(dim)]           # [nm, Q]
    J0 = [[x0_t[d] @ Gmb[b] for b in range(dim)] for d in range(dim)]
    Jv = [[v_t[d] @ Gmb[b] for b in range(dim)] for d in range(dim)]
    BmT = T(np.asarray(disc.Bm).T)
    v_q = [v_t[d] @ BmT for d in range(dim)]               # [E, Q]

    def minor_coeffs(a, b, c, d):
        """t-coefficients of A*B - C*D where A = a0 + t a1 etc."""
        (a0, a1), (b0, b1), (c0, c1), (d0, d1) = a, b, c, d
        return (a0 * b0 - c0 * d0,
                a0 * b1 + a1 * b0 - c0 * d1 - c1 * d0,
                a1 * b1 - c1 * d1)

    def Jp(d, b):
        return (J0[d][b], Jv[d][b])

    lay = poly_layout(dim, Q, FQ)
    nkv = lay["nkv"]
    va = [[None] * dim for _ in range(nkv)]                # [k][b] -> [E, Q]
    det_c = None
    if dim == 3:
        for b in range(3):
            b1, b2 = (b + 1) % 3, (b + 2) % 3
            cof_b = [minor_coeffs(Jp((d + 1) % 3, b1), Jp((d + 2) % 3, b2),
                                  Jp((d + 1) % 3, b2), Jp((d + 2) % 3, b1))
                     for d in range(3)]
            for k in range(3):
                acc = cof_b[0][k] * v_q[0]
                for d in range(1, 3):
                    acc = acc + cof_b[d][k] * v_q[d]
                va[k][b] = acc
            j0, j1 = Jp(0, b)
            c = cof_b[0]
            term = (j0 * c[0], j0 * c[1] + j1 * c[0],
                    j0 * c[2] + j1 * c[1], j1 * c[2])
            det_c = term if det_c is None else tuple(
                p + q for p, q in zip(det_c, term))
    else:
        cols = [[Jp(1, 1), tuple(-x for x in Jp(0, 1))],
                [tuple(-x for x in Jp(1, 0)), Jp(0, 0)]]
        for b in range(2):
            for k in range(2):
                va[k][b] = (cols[b][0][k] * v_q[0]
                            + cols[b][1][k] * v_q[1])
        det_c = minor_coeffs(Jp(0, 0), Jp(1, 1), Jp(0, 1), Jp(1, 0))

    ft = geo.face_tangent_tables(disc.Gmf, disc.n_ref)
    if ft is None:
        raise NotImplementedError(
            "polynomial stage geometry needs axis-aligned reference normals "
            "(ROADMAP.md Queue 1, item 12)")
    Gt, sgn = ft
    GT1 = T((Gt[..., 0] * sgn[:, None, None]).transpose(2, 0, 1)
            .reshape(nm, FQ))
    BmfT = T(np.asarray(disc.Bmf).transpose(2, 0, 1).reshape(nm, FQ))
    vfq = [v_t[d] @ BmfT for d in range(dim)]              # [E, FQ]
    T1 = [(x0_t[d] @ GT1, v_t[d] @ GT1) for d in range(dim)]
    if dim == 3:
        GT2 = T(Gt[..., 1].transpose(2, 0, 1).reshape(nm, FQ))
        T2 = [(x0_t[d] @ GT2, v_t[d] @ GT2) for d in range(dim)]
        vn = [None] * 3
        for d in range(3):
            d1, d2 = (d + 1) % 3, (d + 2) % 3
            nor_d = minor_coeffs(T1[d1], T2[d2], T1[d2], T2[d1])
            for k in range(3):
                t_ = vfq[d] * nor_d[k]
                vn[k] = t_ if vn[k] is None else vn[k] + t_
    else:
        vn = [vfq[0] * T1[1][k] - vfq[1] * T1[0][k] for k in range(2)]

    w_q = T(disc.w_q)
    segs = ([va[k][b] for k in range(nkv) for b in range(dim)]
            + [w_q[None, :] * c for c in det_c] + list(vn))
    P = torch.cat(segs, dim=1)
    assert P.shape == (E, lay["width"])
    return P.contiguous()
