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
contracted over K). The plain versions contract with the dense tables; the
stage kernels (kernels 1, 2 and 5, and kernel 4's volume action) contract
axis by axis with their 1D factors (`sum_factor_tables`): every dense table
of the fused family is a Kronecker product of one 1D table per axis (axis 0
fastest), because the fused stage runs only on tensor-product elements. So
are the mesh tables Bm and Gm, whose 1D factors (`mesh_factor_tables`)
kernels 3 and 4 contract the nodes with.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import basis as B
from .. import geometry as geo

# order of the 1D tables in the packed `sf` block the stage kernels stage in
# shared memory (csrc/stage_core.cuh reads them in this order)
SF_TABLES = ("B1", "G1", "Bw1", "Bgl1", "Bgl21", "Bf1", "wBf1", "A1")
# order of the 1D mesh tables in the packed `msf` block kernels 3 and 4 stage
# (csrc/mesh_geom.cuh)
MESH_TABLES = ("Bm1", "Gm1")


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


def poly16_layout(dim, Q, FQ):
    """Segment offsets of the bf16 stream (the JAX package's va_vn_bf16):
    P = [WDET] alone (`wdet` 0, `width`) and P16 = [VA | VN] (`va` 0, `vn`,
    `width16`), each segment as in `poly_layout`."""
    lay = poly_layout(dim, Q, FQ)
    nva = lay["nkv"] * dim * Q
    return dict(lay, va=0, wdet=0, vn=nva, width=lay["nkd"] * Q,
                width16=nva + lay["nkn"] * FQ)


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


def sum_factor_tables(disc):
    """The 1D factors of the dense stage tables (host numpy, float64).

    With D = p + 1 Bernstein functions and Q1 Gauss-Legendre points per
    axis (the face rule has Q1 points per axis too):
    B1, G1 [Q1, D]: Bernstein values and derivatives at the volume points
    (Bu = B1 x ... x B1; Gu[..., b] has G1 on axis b); Bw1 = w1 B1 (Buw);
    Bgl1 [Q1, D]: the GL nodal basis (Bgl), Bgl21 = Bgl1^2 (Bgl2); A1
    [D, D]: the GL -> Bernstein map (A = A1 x ... x A1); Bf1 [Q1, D] and
    wBf1 = w1 Bf1 at the face points (Bface, SBf over dim - 1 axes)."""
    dim, nd = disc.dim, disc.nd
    D = round(nd ** (1.0 / dim))
    Q1 = round(len(disc.w_q) ** (1.0 / dim))
    Qf = disc.Bface.shape[0]
    if D ** dim != nd or Q1 ** dim != len(disc.w_q) or \
            Q1 ** (dim - 1) != Qf:
        raise ValueError("the stage kernels need tensor-product elements "
                         "with one 1D rule on every axis")
    p = D - 1
    q1, w1 = B.gauss_legendre(Q1)
    unodes = np.linspace(0.0, 1.0, D)
    gl = B.gauss_legendre(D)[0]
    B1 = B.bernstein_vals(p, q1)
    Bgl1 = B.lagrange_vals(gl, q1)
    return dict(
        B1=B1, G1=B.bernstein_grads(p, q1), Bw1=w1[:, None] * B1,
        Bgl1=Bgl1, Bgl21=Bgl1 * Bgl1, Bf1=B1, wBf1=w1[:, None] * B1,
        A1=np.linalg.solve(B.bernstein_vals(p, unodes),
                           B.lagrange_vals(gl, unodes)),
        D=D, Q1=Q1)


def mesh_factor_tables(disc):
    """The 1D factors of the mesh tables (host numpy, float64): with m1 =
    mesh order + 1 Gauss-Lobatto nodes and Q1 Gauss-Legendre points per
    axis, Bm1, Gm1 [Q1, m1]: the Lagrange values and derivatives at the
    volume points (Bm = Bm1 x ... x Bm1; Gm[..., b] has Gm1 on axis b).
    Raises ValueError unless they rebuild disc.Bm and disc.Gm (kernels 3
    and 4 contract with them axis by axis)."""
    dim = disc.dim
    Q, nm = np.asarray(disc.Bm).shape
    m1 = round(nm ** (1.0 / dim))
    Q1 = round(Q ** (1.0 / dim))
    if m1 ** dim != nm or Q1 ** dim != Q:
        raise ValueError("the mesh geometry kernels need tensor-product "
                         "elements with one 1D rule on every axis")
    q1 = B.gauss_legendre(Q1)[0]
    gll = B.gauss_lobatto(m1)
    Bm1, Gm1 = B.lagrange_vals(gll, q1), B.lagrange_grads(gll, q1)
    Bm = B.tensor_mixed([Bm1] * dim)
    Gm = B.tensor_mixed_grads([Bm1] * dim, [Gm1] * dim)
    for got, want in ((Bm, disc.Bm), (Gm, disc.Gm)):
        want = np.asarray(want, np.float64)
        if np.abs(got - want).max() > 1e-12 * np.abs(want).max():
            raise ValueError("the mesh tables are not Kronecker products of "
                             "the Gauss-Lobatto Lagrange 1D tables")
    return dict(Bm1=Bm1, Gm1=Gm1, m1=m1, Q1=Q1)


def mesh_factor_block(disc, dtype, device):
    """The packed block `msf` = [Bm1 | Gm1] ([Q1, m1] each, row-major, in
    MESH_TABLES order) that kernels 3 and 4 stage in shared memory, and the
    sizes m1, Q1."""
    f = mesh_factor_tables(disc)
    msf = np.concatenate([f[k].ravel() for k in MESH_TABLES])
    return dict(msf=torch.as_tensor(msf, dtype=dtype, device=device),
                m1=f["m1"], Q1=f["Q1"])


def face_descriptors(disc):
    """The face descriptors of kernel 5's face geometry (host numpy): int32
    fdesc[nf, 5] = (normal axis k, side (0: the low end, 1: the high end),
    the axis of the first tangent, of the second (3D: (k+1)%3, (k+2)%3; 2D:
    1 - k and -1), the reference-normal sign of
    `geometry.face_tangent_tables`: +-1, in 2D times -1 where k != 0).

    The face's nodes are the mesh nodes with index 0 (side 0) or m1 - 1
    (side 1) along k, and its points are numbered with the lower in-face
    axis fastest. Raises ValueError unless the descriptors and the 1D mesh
    tables Bm1, Gm1 (`mesh_factor_tables`) rebuild the dense face tables of
    the plain version to 1e-13 of their largest entry in f64: the first
    tangent with the sign folded in and the second (3D), both from
    disc.Gmf, and disc.Bmf (`face_factor_rebuild`)."""
    ft = geo.face_tangent_tables(disc.Gmf, disc.n_ref)
    if ft is None:
        raise ValueError(
            "the stage from the nodes needs axis-aligned reference normals "
            "(a tensor element of dimension 2 or 3; a 1D point face has no "
            "tangent)")
    Gt, sgn = ft
    n_ref = np.asarray(disc.n_ref)
    dim = n_ref.shape[1]
    k = np.abs(n_ref).argmax(axis=1)
    side = (np.take_along_axis(n_ref, k[:, None], 1)[:, 0] > 0).astype(int)
    if dim == 3:
        t1, t2 = (k + 1) % 3, (k + 2) % 3
    else:
        t1, t2 = 1 - k, -np.ones_like(k)
    fdesc = np.stack([k, side, t1, t2, np.rint(sgn).astype(int)],
                     axis=1).astype(np.int32)
    rebuilt = face_factor_rebuild(fdesc, mesh_factor_tables(disc))
    want = dict(GT1=Gt[..., 0] * sgn[:, None, None], Bmf=disc.Bmf)
    if dim == 3:
        want["GT2"] = Gt[..., 1]
    for name, w in want.items():
        w = np.asarray(w, np.float64)
        got = rebuilt[name]
        if (got.shape != w.shape or
                np.abs(got - w).max() > 1e-13 * np.abs(w).max()):
            raise ValueError(f"the face table {name} is not the face "
                             "descriptors' rebuild from the 1D mesh tables")
    return fdesc


def face_factor_rebuild(fdesc, mesh_tables):
    """The dense face tables [nf, Qf, nm] that the descriptors fdesc and
    the 1D mesh tables (`mesh_factor_tables`) stand for: GT1 (the first
    tangent's derivative table, sign folded in), GT2 (3D) and Bmf. Per face
    a Kronecker product, axis 0 fastest: along the normal axis the one-hot
    row of the face's node, along the tangent axis Gm1, along the other
    in-face axis Bm1."""
    Bm1, Gm1, m1 = (mesh_tables[k] for k in ("Bm1", "Gm1", "m1"))
    dim = 3 if fdesc[0, 3] >= 0 else 2
    out = {"GT1": [], "GT2": [], "Bmf": []}
    for k, side, t1, t2, sign in fdesc:
        end = np.zeros((1, m1))
        end[0, m1 - 1 if side else 0] = 1.0

        def table(deriv):
            return B.tensor_mixed([end if a == k else
                                   (Gm1 if a == deriv else Bm1)
                                   for a in range(dim)])

        out["GT1"].append(sign * table(t1))
        if dim == 3:
            out["GT2"].append(table(t2))
        out["Bmf"].append(table(-1))
    return {n: np.stack(v) for n, v in out.items() if v}


def stage_ho_tables(disc, dtype, device):
    """Static tables of the stage kernels (built once per Advection): the
    dense tables of the plain versions, the packed 1D factors `sf` the
    kernels read (`sum_factor_tables`, in SF_TABLES order) and the sizes.
    The tables are checked once here (`check_tables`)."""
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

    sf = sum_factor_tables(disc)
    tb = dict(
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
        sf=F(np.concatenate([sf[k].ravel() for k in SF_TABLES])),
        dim=dim, nd=nd, Q=Q, Qf=Qf, nf=nf, fd=fd, D=sf["D"], Q1=sf["Q1"])
    check_tables(tb)
    return tb


def build_poly_tables(x0, v, disc, va_vn_bf16=False):
    """P[E, width]: the t-polynomial coefficients of the stage geometry.

    In remap the mesh moves linearly, J(t) = J0 + t Jv, so the convective
    velocity va_b = v . cof(J)[:, b], w_q det J and the face normal velocity
    vn = v . n are polynomials in t whose coefficients are computed once
    here; the stage kernel evaluates them by Horner's rule. Computed in the
    dtype of x0 (layout: `poly_layout`).

    va_vn_bf16 (remhos_tpu/ops/pallas_kernels.py:975, f32 only): returns
    (P, P16), P = [WDET] in the dtype of x0 and P16 = [VA | VN] rounded to
    bf16 (`poly16_layout`). w_q det J stays in the working type: it makes
    the lumped mass and the LO average, which decide conservation. va and
    vn round independently, so the discrete volume/face telescoping that
    makes du_HO conservative holds only to bf16's ~4e-3, and the f32 mass
    closure's injection budget is the gate."""
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
        raise ValueError(
            "polynomial stage geometry needs axis-aligned reference normals "
            "(a tensor element of dimension 2 or 3; a 1D point face has no "
            "tangent)")
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
    va_segs = [va[k][b] for k in range(nkv) for b in range(dim)]
    wd_segs = [w_q[None, :] * c for c in det_c]
    if va_vn_bf16:
        return (torch.cat(wd_segs, dim=1).contiguous(),
                torch.cat(va_segs + list(vn), dim=1).to(
                    torch.bfloat16).contiguous())
    P = torch.cat(va_segs + wd_segs + list(vn), dim=1)
    assert P.shape == (E, lay["width"])
    return P.contiguous()


def table_shapes(tb, extra=()):
    """The shape each static table must have: the dense tables, the packed
    1D factors `sf` and the int tables (`extra`: more (name, shape) pairs,
    e.g. kernel 5's geometry tables)."""
    dim, nd, Q, Qf, nf, fd = (tb[k] for k in ("dim", "nd", "Q", "Qf", "nf",
                                               "fd"))
    shapes = dict(GuT=(nd, dim * Q), Buw=(Q, nd), Bface=(Qf, fd),
                  SBf=(Qf, fd), A=(nd, nd), AT=(nd, nd), BglT=(nd, Q),
                  Bgl=(Q, nd), Bgl2=(Q, nd), Bu=(Q, nd), w_q=(Q,),
                  bdr=(nf, fd), dof_faces=(nd, dim), cls=(nd,))
    if "sf" in tb:
        D, Q1 = tb["D"], tb["Q1"]
        shapes["sf"] = ((len(SF_TABLES) - 1) * Q1 * D + D * D,)
    shapes.update(extra)
    return shapes


INT_NAMES = ("bdr", "dof_faces", "cls", "fdesc")


def check_tables(tb, extra=(), key="checked", shapes=None):
    """Check the static tables once and record it: tb[key] = (dtype,
    device). Every float table has the dtype of w_q (float32 or float64),
    the int tables are int32, all on one device, contiguous, with the
    shapes of `table_shapes` (or `shapes`, {name: shape}, for the tables of
    kernels 3 and 4). Raises TypeError or ValueError as the wrappers'
    operand checks do."""
    dtype, device = tb["w_q"].dtype, tb["w_q"].device
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"the tables are {dtype}, not float32 or float64")
    if shapes is None:
        shapes = table_shapes(tb, extra)
    for name, shape in shapes.items():
        x = tb[name]
        if x is None:
            continue
        want = torch.int32 if name in INT_NAMES else dtype
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(x.shape)}")
        if x.dtype != want:
            raise TypeError(f"{name} is {x.dtype}, must be {want}")
        if x.device != device:
            raise ValueError(f"{name} is on {x.device}, w_q on {device}")
        if device.type == "cuda" and not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    tb[key] = (dtype, device)
    return tb[key]
