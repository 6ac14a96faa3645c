"""The plain reference of a remap phase: the benchmark's yardstick of
`correct`.

One remap phase of Remhos's partial-assembly remap on a Cartesian hex (or
quad) mesh, written as plain PyTorch from the discretization up, for the
solver sets the benchmark's configurations name: `-ho 3` (the element-local
mass inverse) with `-lo 5` (MassBasedAvg) or `-lo 3` (residual
distribution), `-fct 2` (ClipScale), `-bt 0` overlap bounds, optionally the
product field us = u s (`-ps`), RK3-SSP, and the conservative mass closure
on u after every step. It imports nothing of the measured program and takes
nothing it made: the mesh, the mesh velocity, the bases and every table are
built here from the sizes alone.

The formulation is the non-fused one: every stage forms the geometry at the
moved nodes x0 + t v (Jacobians, cofactors, face normals from the tangents)
and solves the element mass matrices by Jacobi-preconditioned CG in the
Gauss-Legendre nodal basis to `cg_tol`. The program's fused stage carries
the same geometry as polynomials in t, which are exact for a linearly moving
mesh, so both compute the same function.

Precision: `dtype` float64 is the reference. The control of the benchmark
runs the same code in float32 with every matrix product's operands rounded
to TF32's 10-bit mantissa (`tf32=True`), the step below float32 that a GPU
offers for products.
"""

from __future__ import annotations

import math
from math import comb

import numpy as np
import torch

FACES = {2: ((1, 0), (0, 1), (1, 1), (0, 0)),
         3: ((2, 0), (1, 0), (0, 1), (1, 1), (0, 0), (2, 1))}
EMPTY_TOL = 1e-12        # a dof with u above this is active (-ps)
EPS_RD = 1e-15           # residual-distribution weight guard
EPS_CS = 1e-15           # ClipScale rescale guard
EPS_PROD = 1e-12         # product-bound round-off guard
CG_MAX = 200             # the mass solve's iteration cap
INF = float("inf")


# ---------------------------------------------------------------------------
# 1D bases (host numpy, float64)
# ---------------------------------------------------------------------------

def gauss_legendre(n):
    x, w = np.polynomial.legendre.leggauss(n)
    return 0.5 * (x + 1.0), 0.5 * w


def gauss_lobatto(n):
    """n Gauss-Lobatto points on [0, 1]: the roots of P'_{n-1} and the
    endpoints."""
    if n == 2:
        return np.array([0.0, 1.0])
    inner = np.polynomial.legendre.Legendre.basis(n - 1).deriv().roots()
    return 0.5 * (np.concatenate([[-1.0], np.sort(inner.real), [1.0]]) + 1)


def bernstein(p, x):
    """(values, derivatives) [len(x), p+1] of the Bernstein basis."""
    x = np.asarray(x, np.float64)

    def vals(q):
        i = np.arange(q + 1)
        c = np.array([comb(q, k) for k in i], np.float64)
        return c * x[:, None] ** i * (1.0 - x[:, None]) ** (q - i)

    d = np.zeros((len(x), p + 1))
    if p > 0:
        low = vals(p - 1)
        d[:, :-1] -= p * low
        d[:, 1:] += p * low
    return vals(p), d


def lagrange(nodes, x):
    """(values, derivatives) [len(x), len(nodes)] of the Lagrange basis."""
    nodes, x = np.asarray(nodes, np.float64), np.asarray(x, np.float64)
    n = len(nodes)
    v, g = np.ones((len(x), n)), np.zeros((len(x), n))
    for i in range(n):
        others = [j for j in range(n) if j != i]
        for j in others:
            v[:, i] *= (x - nodes[j]) / (nodes[i] - nodes[j])
        for k in others:
            term = np.full(len(x), 1.0 / (nodes[i] - nodes[k]))
            for j in others:
                if j != k:
                    term *= (x - nodes[j]) / (nodes[i] - nodes[j])
            g[:, i] += term
    return v, g


def kron(tables):
    """Tensor product of per-axis tables [nq_a, nb_a], axis 0 fastest in
    both the point and the basis index."""
    out = tables[0]
    for t in tables[1:]:
        out = np.einsum("qb,rc->rqcb", out, t).reshape(
            out.shape[0] * t.shape[0], out.shape[1] * t.shape[1])
    return out


def kron_grads(vals, grads):
    """[Q, B, dim]: derivative d/dxi_b of the tensor basis."""
    dim = len(vals)
    return np.stack([kron([grads[a] if a == b else vals[a]
                           for a in range(dim)]) for b in range(dim)], -1)


def lex(n1, dim):
    """[(n1)^dim, dim] multi-indices, axis 0 fastest."""
    g = np.meshgrid(*[np.arange(n1)] * dim, indexing="ij")
    return np.stack([a.ravel(order="F") for a in g], -1)


# ---------------------------------------------------------------------------
# the mesh, the space and the mesh velocity
# ---------------------------------------------------------------------------

class Space:
    """An n^dim Cartesian mesh of [0, 1]^dim (not periodic) with mesh order
    2 (Gauss-Lobatto nodes), the order-p Bernstein DG space on it, and the
    quadrature rules of MFEM's mass and convection integrators (volume and
    face: order 2p + 2 dim - 1). Element e = ix + n iy + n^2 iz. Tables are
    float64 tensors on `device`."""

    def __init__(self, n, p, dim=3, device="cpu", mesh_order=2):
        self.n, self.p, self.dim, self.device = n, p, dim, device
        self.shape = (n,) * dim
        self.E = n ** dim
        n1 = p + 1
        self.nd, self.fd = n1 ** dim, n1 ** (dim - 1)
        self.faces = FACES[dim]
        gll = gauss_lobatto(mesh_order + 1)
        # nodes: per element, the GLL grid of its box
        ref = gll[lex(mesh_order + 1, dim)]                    # [nm, dim]
        eidx = lex(n, dim)                                     # [E, dim]
        h = 1.0 / n
        self.x0 = self._T((eidx[:, None, :] + ref[None]) * h)  # [E, nm, dim]
        order = 2 * p + mesh_order * dim - 1
        q1, w1 = gauss_legendre(order // 2 + 1)
        B1, G1 = bernstein(p, q1)
        M1, MG1 = lagrange(gll, q1)
        T = self._T
        self.w_q = T(kron([w1[:, None]] * dim)[:, 0])
        self.Bu = T(kron([B1] * dim))                          # [Q, nd]
        self.Gu = T(kron_grads([B1] * dim, [G1] * dim))        # [Q, nd, dim]
        self.Bm = T(kron([M1] * dim))                          # [Q, nm]
        self.Gm = T(kron_grads([M1] * dim, [MG1] * dim))       # [Q, nm, dim]
        # the face rule: the volume rule's 1D points on dim-1 axes
        self.w_fq = T(kron([w1[:, None]] * (dim - 1))[:, 0])
        self.Bface = T(kron([B1] * (dim - 1)))                 # [Qf, fd]
        # per face: the mesh basis and its tangential derivatives at the
        # face points, and the sign of the outward reference normal
        midx = lex(n1, dim)
        Bmf, Gt, sign, bdr = [], [], [], []
        for axis, side in self.faces:
            end = np.array([float(side)])
            Me, MGe = lagrange(gll, end)
            vals = [Me if a == axis else M1 for a in range(dim)]
            grads = [MGe if a == axis else MG1 for a in range(dim)]
            Bmf.append(kron(vals))
            G = kron_grads(vals, grads)
            tang = ([(axis + 1) % 3, (axis + 2) % 3] if dim == 3
                    else [1 - axis])
            Gt.append(G[..., tang])
            s = 1.0 if side == 1 else -1.0
            if dim == 2 and axis == 1:
                s = -s
            sign.append(s)
            # the element's dofs on this face, tangential lex order
            sel = np.where(midx[:, axis] == (p if side else 0))[0]
            key = np.zeros(len(sel), np.int64)
            mult = 1
            for a in range(dim):
                if a != axis:
                    key += midx[sel, a] * mult
                    mult *= n1
            bdr.append(sel[np.argsort(key, kind="stable")])
        self.Bmf, self.Gmf_tan = T(np.stack(Bmf)), T(np.stack(Gt))
        self.face_sign = T(np.array(sign))
        bdr = np.stack(bdr)
        opp = [self.faces.index((a, 1 - s)) for a, s in self.faces]
        self.bdr = torch.as_tensor(bdr, device=device)         # [nf, fd]
        self.nbr_dof = torch.as_tensor(bdr[opp], device=device)
        # the Gauss-Legendre nodal basis of the mass solve and its map to
        # Bernstein coefficients (both tensor products of 1D ones)
        gl = gauss_legendre(n1)[0]
        un = np.linspace(0.0, 1.0, n1)
        self.Bgl = T(kron([lagrange(gl, q1)[0]] * dim))        # [Q, nd]
        A1 = np.linalg.solve(bernstein(p, un)[0], lagrange(gl, un)[0])
        self.A_gl2b = T(kron([A1] * dim))                      # [nd, nd]
        # the closed-uniform points whose values are the Bernstein dofs of
        # a projected function (MFEM's PositiveFiniteElement::Project)
        self.Bm_unodes = T(kron([lagrange(gll, un)[0]] * dim))  # [nd, nm]
        # per axis, the position class of each dof: 0 low end, 1 interior,
        # 2 high end (which neighbours share its overlap-bounds node)
        self.dof_class = [tuple(c) for c in
                          np.where(midx == 0, 0, np.where(midx == p, 2, 1))]

    def _T(self, a):
        return torch.as_tensor(np.asarray(a, np.float64),
                               device=self.device)

    def bernstein_points(self):
        """[E, nd, dim] positions whose function values are the Bernstein
        coefficients of the projection."""
        return torch.einsum("emd,nm->end", self.x0, self.Bm_unodes)


def taylor_green(x):
    """Remap problem 10's mesh velocity (Taylor-Green) on [0, 1]^dim."""
    Y = x
    v0 = torch.sin(math.pi * Y[..., 0]) * torch.cos(math.pi * Y[..., 1])
    v1 = -torch.cos(math.pi * Y[..., 0]) * torch.sin(math.pi * Y[..., 1])
    if x.shape[-1] == 3:
        cz = torch.cos(math.pi * Y[..., 2])
        return torch.stack([v0 * cz, v1 * cz, torch.zeros_like(v0)], -1)
    return torch.stack([v0, v1], -1)


def mesh_velocity(x0, dt, t_final=0.7):
    """v = x(t_final) - x0, the nodes moved by forward Euler steps of dt
    through the velocity field (the reference's loop, remhos.cpp:560-584,
    with its last-step rule)."""
    t, steps = 0.0, []
    while t < t_final:
        t += dt
        steps.append(min(dt, t_final - t))
    x = x0
    for h in steps:
        x = x + h * taylor_green(x)
    return x - x0


# ---------------------------------------------------------------------------
# the remap operator
# ---------------------------------------------------------------------------

def _tf32(a):
    """a (float32) with its mantissa rounded to TF32's 10 bits, to the
    nearest, ties to even."""
    i = a.contiguous().view(torch.int32)
    i = (i + 0x0FFF + ((i >> 13) & 1)) & ~0x1FFF
    return i.view(torch.float32)


class Remap:
    """The stage and the phase of one configuration on `space`.

    lo: 5 (MassBasedAvg) or 3 (residual distribution); product: a second
    field us = u s limited by the product sync. dtype float64 (the
    reference) or float32; tf32 rounds every product's operands to TF32
    (the control)."""

    def __init__(self, space, v, lo, product=False, dtype=torch.float64,
                 tf32=False):
        if lo not in (3, 5):
            raise ValueError(f"lo must be 3 or 5, got {lo}")
        if tf32 and dtype != torch.float32:
            raise ValueError("tf32 rounds float32 operands")
        sp = self.sp = space
        self.lo, self.product, self.dtype, self.tf32 = lo, product, dtype, tf32
        self.cg_tol = 1e-13 if dtype == torch.float64 else 1e-6

        def C(a):
            return a.to(dtype)

        self.x0, self.v = C(sp.x0), C(v)
        self.w_q, self.Bu, self.Bface = C(sp.w_q), C(sp.Bu), C(sp.Bface)
        self.w_fq, self.sign = C(sp.w_fq), C(sp.face_sign)
        Q, nd, dim = sp.Gu.shape
        self.GuT = C(sp.Gu.permute(1, 2, 0).reshape(nd, dim * Q))
        self.Buw = C(sp.Bu * sp.w_q[:, None])
        self.Bgl, self.A = C(sp.Bgl), C(sp.A_gl2b)
        self.Gm, self.Bmf, self.Gt = C(sp.Gm), C(sp.Bmf), C(sp.Gmf_tan)
        # the velocity does not depend on t: its values at the volume and
        # face points, made once
        self.v_q = self._interp(self.v, C(sp.Bm))              # [E, Q, dim]
        nf, Qf, nm = sp.Bmf.shape
        self.v_fq = self._interp(self.v, self.Bmf.reshape(nf * Qf, nm)
                                 ).reshape(sp.E, nf, Qf, dim)

    def mm(self, a, b):
        if self.tf32:
            return _tf32(a) @ _tf32(b)
        return a @ b

    def _interp(self, x, Bt):
        """x[E, nm, dim] at points: Bt[P, nm] -> [E, P, dim]."""
        E, nm, dim = x.shape
        y = self.mm(x.transpose(1, 2).reshape(E * dim, nm), Bt.T)
        return y.reshape(E, dim, -1).transpose(1, 2)

    # -- geometry at the stage time ----------------------------------------

    def geometry(self, t):
        """{wdet [E, Q], va [E, Q, dim], wvn [E, nf, Qf], ml [E, nd]} at the
        nodes x0 + t v: w_q det J, adj(J) v (the convection's velocity in
        reference coordinates), the upwind face weights w_f max(v.n, 0)
        with n the scaled outward normal from the face tangents, and the
        lumped mass."""
        x = self.x0 + t * self.v
        E, nm, dim = x.shape
        A = x.transpose(1, 2).reshape(E * dim, nm)
        # J[d][b] = dx_d / dxi_b at the volume points, each [E, Q]
        cols = [self.mm(A, self.Gm[:, :, b].T).reshape(E, dim, -1)
                for b in range(dim)]
        J = [[cols[b][:, d] for b in range(dim)] for d in range(dim)]
        if dim == 3:
            cof = [[J[(d + 1) % 3][(b + 1) % 3] * J[(d + 2) % 3][(b + 2) % 3]
                    - J[(d + 1) % 3][(b + 2) % 3] * J[(d + 2) % 3][(b + 1) % 3]
                    for b in range(3)] for d in range(3)]
        else:
            cof = [[J[1][1], -J[1][0]], [-J[0][1], J[0][0]]]
        det = sum(J[0][b] * cof[0][b] for b in range(dim))
        va = torch.stack([sum(cof[d][b] * self.v_q[..., d]
                              for d in range(dim)) for b in range(dim)], -1)
        nf, Qf, _, tdim = self.Gt.shape
        G2 = self.Gt.permute(2, 0, 1, 3).reshape(nm, nf * Qf * tdim)
        Tg = self.mm(A, G2).reshape(E, dim, nf, Qf, tdim).permute(
            0, 2, 3, 1, 4)
        if dim == 3:
            nor = torch.linalg.cross(Tg[..., 0], Tg[..., 1], dim=-1)
        else:
            nor = torch.stack([Tg[..., 0][..., 1], -Tg[..., 0][..., 0]], -1)
        nor = nor * self.sign[None, :, None, None]
        vn = (self.v_fq * nor).sum(-1)
        wdet = self.w_q[None, :] * det
        return dict(wdet=wdet, va=va,
                    wvn=self.w_fq[None, None, :] * vn.clamp(min=0.0),
                    ml=self.mm(wdet, self.Bu))

    # -- the operators -------------------------------------------------------

    def gather_nbr(self, u):
        """u_nbr[E, nf, fd]: the neighbour's values at each face dof, 0 on
        the boundary of the (non-periodic) box."""
        sp = self.sp
        grid = u.reshape(tuple(reversed(sp.shape)) + (sp.nd,))
        outs = []
        for f, (axis, side) in enumerate(sp.faces):
            vals = grid[..., sp.nbr_dof[f]]           # neighbour-side dofs
            g = sp.dim - 1 - axis                      # grid dimension
            n = vals.shape[g]
            pad = torch.zeros_like(vals.narrow(g, 0, 1))
            if side == 1:
                nb = torch.cat([vals.narrow(g, 1, n - 1), pad], g)
            else:
                nb = torch.cat([pad, vals.narrow(g, 0, n - 1)], g)
            outs.append(nb.reshape(sp.E, sp.fd))
        return torch.stack(outs, 1)

    def conv_volume(self, geom, u):
        """The volume part of K u: int (adj(J) v . grad_xi u) phi_i."""
        Q = self.w_q.shape[0]
        dim = self.sp.dim
        grad = self.mm(u, self.GuT)                            # [E, dim*Q]
        du_q = sum(geom["va"][..., b] * grad[:, b * Q:(b + 1) * Q]
                   for b in range(dim))
        return self.mm(du_q, self.Buw)

    def face_values(self, u, u_nbr, geom, lumped):
        """The DG upwind face terms scattered into the element dofs: full
        (the HO operator) or row-lumped (the residual-distribution LO)."""
        sp = self.sp
        u_face = u[:, sp.bdr]                                  # [E, nf, fd]
        if lumped:
            contrib = self.mm(geom["wvn"], self.Bface) * (u_nbr - u_face)
        else:
            fq = geom["wvn"] * self.mm(u_nbr - u_face, self.Bface.T)
            contrib = self.mm(fq, self.Bface)
        return torch.zeros_like(u).index_add(
            1, sp.bdr.reshape(-1), contrib.reshape(u.shape[0], -1))

    def mass_solve(self, rhs, wdet):
        """M^-1 rhs, M the Bernstein mass matrix of each element: Jacobi-CG
        in the Gauss-Legendre nodal basis (du = A g, A^T M A g = A^T rhs)
        until |r| <= cg_tol |b| over all elements."""
        b = self.mm(rhs, self.A)
        inv_diag = 1.0 / self.mm(wdet, self.Bgl * self.Bgl)

        def M(x):
            return self.mm(self.mm(x, self.Bgl.T) * wdet, self.Bgl)

        x = torch.zeros_like(b)
        r, z = b, inv_diag * b
        p, rz = z, (b * z).sum()
        tol2 = self.cg_tol ** 2 * (b * b).sum()
        for _ in range(CG_MAX):
            if not bool((r * r).sum() > tol2):
                break
            Ap = M(p)
            alpha = rz / (p * Ap).sum()
            x, r = x + alpha * p, r - alpha * Ap
            z = inv_diag * r
            rz_new = (r * z).sum()
            p, rz = z + (rz_new / rz) * p, rz_new
        return self.mm(x, self.A.T)

    def ho(self, geom, u, u_nbr, Kv):
        return self.mass_solve(Kv + self.face_values(u, u_nbr, geom, False),
                               geom["wdet"])

    def lo_rate(self, geom, u, u_nbr, Kv, du_ho, dt):
        if self.lo == 5:
            # MassBasedAvg: the element average of u + dt du_HO
            u_q = self.mm(u + dt * du_ho, self.Bu.T)
            wdet = geom["wdet"]
            avg = (wdet * u_q).sum(1) / wdet.sum(1)
            return (avg[:, None] - u) / dt
        # residual distribution (remhos_lo.cpp:111-245) of z = K_vol u on
        # the lumped face terms
        duf = self.face_values(u, u_nbr, geom, True)
        rhoP, rhoN = Kv.clamp(min=0.0).sum(1), Kv.clamp(max=0.0).sum(1)
        numP = u.amax(1, keepdim=True) - u
        numN = u.amin(1, keepdim=True) - u
        wP = numP / (numP.sum(1, keepdim=True) + EPS_RD)
        wN = numN / (numN.sum(1, keepdim=True) - EPS_RD)
        return (duf + wP * rhoP[:, None] + wN * rhoN[:, None]) / geom["ml"]

    def overlap_bounds(self, el_min, el_max):
        """Per-dof bounds: the extrema over the elements that share the
        dof's Gauss-Lobatto node (ComputeOverlapBounds on a grid): per
        axis, a low-end dof also sees the low neighbour, a high-end dof the
        high one."""
        sp = self.sp
        gshape = tuple(reversed(sp.shape))
        out = []
        for vals, worst, red in ((el_min, INF, torch.minimum),
                                 (el_max, -INF, torch.maximum)):
            g = torch.nn.functional.pad(vals.reshape(gshape),
                                        (1, 1) * sp.dim, value=worst)
            # per class combination (c_axis in 0, 1, 2), the extremum over
            # the neighbour offsets that class shares
            cls_vals = {}
            for cls in np.ndindex(*(3,) * sp.dim):      # cls[a] of axis a
                acc = None
                offs = [(-1, 0) if c == 0 else (0,) if c == 1 else (0, 1)
                        for c in cls]
                for o in np.ndindex(*[len(x) for x in offs]):
                    sl = tuple(slice(1 + offs[a][o[a]],
                                     1 + offs[a][o[a]] + sp.shape[a])
                               for a in reversed(range(sp.dim)))
                    w = g[sl]
                    acc = w if acc is None else red(acc, w)
                cls_vals[cls] = acc.reshape(-1)
            out.append(torch.stack([cls_vals[c] for c in sp.dof_class], 1))
        return out

    def bounds(self, u, active_dof=None, active_el=None):
        lo, hi = u, u
        if active_dof is not None:
            lo = torch.where(active_dof, u, INF)
            hi = torch.where(active_dof, u, -INF)
        el_min, el_max = lo.amin(1), hi.amax(1)
        if active_el is not None:
            el_min = torch.where(active_el, el_min, INF)
            el_max = torch.where(active_el, el_max, -INF)
        return self.overlap_bounds(el_min, el_max)

    @staticmethod
    def clip_scale(u, m, du_ho, du_lo, u_min, u_max, dt):
        """ClipScale (remhos_fct.cpp:440-511): the antidiffusive fluxes
        clipped to the bounds, then rescaled to a zero element sum."""
        u_lo = u + dt * du_lo
        f = torch.minimum(m / dt * (u_max - u_lo),
                          torch.maximum(m / dt * (u_min - u_lo),
                                        m * (du_ho - du_lo)))
        fpos, fneg = f.clamp(min=0.0), f.clamp(max=0.0)
        sp, sn = fpos.sum(1, keepdim=True), fneg.sum(1, keepdim=True)
        net = sn + sp
        f = torch.where(net > EPS_CS, fneg - fpos * (sn / sp), f)
        f = torch.where(net < -EPS_CS, fpos - fneg * (sp / sn), f)
        return du_lo + f / m

    def product_rate(self, geom, us, dus_ho, u, du_u, dt):
        """The product field's limited rate (remhos_fct.cpp:26-262,
        remhos_sync.cpp): bounds of s = us/u on the active dofs, the
        compatible LO update u_new s_avg, ClipScale against s_min u_new and
        s_max u_new, empty dofs zeroed."""
        act_dof = u > EMPTY_TOL
        act_el = act_dof.any(1)
        ratio = us / torch.where(act_dof, u, 1.0)
        cnt = act_dof.sum(1).clamp(min=1)
        s_avg_el = torch.where(act_dof, ratio, 0.0).sum(1) / cnt
        s = torch.where(act_dof, ratio, s_avg_el[:, None])
        s = torch.where(act_el[:, None], s, 0.0)
        s_min, s_max = self.bounds(s, act_dof, act_el)
        u_new = u + dt * du_u
        new_dof = u_new > EMPTY_TOL
        new_el = new_dof.any(1)
        m = geom["ml"]
        a = new_el[:, None]
        mass_us = torch.where(a, (us + dt * dus_ho) * m, 0.0).sum(1)
        mass_u = torch.where(a, u_new * m, 0.0).sum(1)
        s_avg = torch.where(new_el, mass_us / torch.where(new_el, mass_u,
                                                          1.0), 0.0)
        smin = torch.where(new_dof, s_min, INF).amin(1)
        smax = torch.where(new_dof, s_max, -INF).amax(1)
        s_avg = torch.where((s_avg < smin)
                            & (mass_us + EPS_PROD > smin * mass_u),
                            smin, s_avg)
        s_avg = torch.where((s_avg > smax)
                            & (mass_us - EPS_PROD < smax * mass_u),
                            smax, s_avg)
        sa = s_avg[:, None]
        widen = a & new_dof
        s_min = torch.where(widen & (sa + EPS_PROD < s_min), sa, s_min)
        s_max = torch.where(widen & (sa - EPS_PROD > s_max), sa, s_max)
        dus_lo = torch.where(a, (u_new * sa - us) / dt, 0.0)
        live = a & new_dof
        us_min = torch.where(live, s_min * u_new, 0.0)
        us_max = torch.where(live, s_max * u_new, 0.0)
        d = self.clip_scale(us, m, dus_ho, dus_lo, us_min, us_max, dt)
        return torch.where(a | new_dof, d, 0.0)

    def stage(self, t, dt, S):
        """The limited rate dS[nfields, E, nd] of the state S at time t."""
        geom = self.geometry(t)
        u = S[0]
        u_nbr = self.gather_nbr(u)
        Kv = self.conv_volume(geom, u)
        du_ho = self.ho(geom, u, u_nbr, Kv)
        du_lo = self.lo_rate(geom, u, u_nbr, Kv, du_ho, dt)
        x_min, x_max = self.bounds(u)
        du = self.clip_scale(u, geom["ml"], du_ho, du_lo, x_min, x_max, dt)
        if not self.product:
            return du[None]
        us = S[1]
        dus_ho = self.ho(geom, us, self.gather_nbr(us),
                         self.conv_volume(geom, us))
        return torch.stack([du, self.product_rate(geom, us, dus_ho, u, du,
                                                  dt)])

    def mass(self, t, u):
        """(<ml(t), u>, sum of ml(t)) in float64."""
        ml = self.geometry(t)["ml"].double()
        return (ml * u.double()).sum(), ml.sum()

    def phase(self, S0, steps, dt):
        """`steps` RK3-SSP steps from S0[nfields, E, nd] at t = 0, with the
        mass of u pinned after each step to its value at t = 0 by a uniform
        shift (the conservative closure). Returns the final state."""
        S = S0.to(self.dtype)
        m0 = self.mass(0.0, S[0])[0]
        t = 0.0
        for _ in range(steps):
            k1 = self.stage(t, dt, S)
            y = S + dt * k1
            k2 = self.stage(t + dt, dt, y)
            y = 0.75 * S + 0.25 * (y + dt * k2)
            k3 = self.stage(t + dt / 2, dt, y)
            S = S + (dt / 6.0) * (k1 + k2 + 4.0 * k3)
            t += dt
            mt, vol = self.mass(t, S[0])
            S = S.clone()
            S[0] = S[0] + ((m0 - mt) / vol).to(S.dtype)
        return S


# ---------------------------------------------------------------------------
# the interface the harness finds by a configuration's "reference" key
# ---------------------------------------------------------------------------

def _supported(config):
    """Raise unless this reference computes what `config` asks for."""
    s = config["solver"]
    want = dict(problem=10, ho=3, fct=2, ode_solver=3, bounds_type=0,
                pa=True)
    off = {k: s.get(k) for k in want if s.get(k) != want[k]}
    if off or s["lo"] not in (3, 5) or config.get("mesh") != "cartesian":
        raise ValueError(f"perfbench/reference/remap.py computes -p 10 "
                         f"-ho 3 -lo 3|5 -fct 2 -bt 0 -s 3 on a Cartesian "
                         f"mesh; the configuration asks {off or s}")


def points(config, traffic, device):
    """[E, nd, dim] float64: the points whose field values are the
    Bernstein coefficients of the cell's initial fields."""
    _supported(config)
    sp = Space(traffic["n"], config["order"], config["dim"], device,
               config["mesh_order"])
    return sp.bernstein_points()


class Reference:
    """A cell's phase in the reference: `phase(S0)` the final state,
    `mass(t, u)` the mass of u in the lumped mass at pseudo-time t (float64,
    cached per t), `t_end` the pseudo-time a phase ends at. dtype and tf32
    as `Remap`'s (the control)."""

    def __init__(self, config, traffic, device, dtype=torch.float64,
                 tf32=False):
        _supported(config)
        sp = Space(traffic["n"], config["order"], config["dim"], device,
                   config["mesh_order"])
        self.steps, self.dt = traffic["steps_per_remap"], traffic["dt"]
        self.t_end = self.steps * self.dt
        v = mesh_velocity(sp.x0, self.dt, config["mesh_t_final"])
        self.op = Remap(sp, v, config["solver"]["lo"],
                        product=config["solver"]["product_sync"],
                        dtype=dtype, tf32=tf32)
        self._ml = {}

    def phase(self, S0):
        return self.op.phase(S0, self.steps, self.dt)

    def mass(self, t, u):
        if t not in self._ml:
            self._ml[t] = self.op.geometry(t)["ml"].double()
        return float((self._ml[t] * u.double()).sum())
