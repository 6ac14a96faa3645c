"""The plain reference of an assembled remap phase: the benchmark's yardstick
of `correct` for Remhos's matrix-based solver set.

One remap phase of Remhos's full-assembly remap (no `-pa`) on a Cartesian
hex mesh, written as plain PyTorch from the discretization up, for the
solver set `-ho 3 -lo 1 -fct 1 -bt 0 -s 3` (the CI's `remap-cube3d-m5`):

- the element matrices of every stage at the moved nodes x0 + t v: the
  Bernstein mass M (MassIntegrator), the volume convection K
  (ConvectionIntegrator(v)), and the DG upwind trace of K_HO
  (remhos.cpp:646-679) as explicit face blocks: for each face of each
  element, with the upwind weight w_f max(0, v.n), the own-own block
  -int phi_i phi_j and, across an interior face, the own-neighbour block
  +int phi_i phi_j;
- HO, LocalInverse (remhos_ho.cpp:84-128): du_HO = M^-1 K_HO u, a dense
  solve of each element's M;
- LO, DiscreteUpwind (remhos_lo.cpp:31-100): D = K + d on the volume
  matrix alone (Remhos's `k` form has no face integrator), d_ij =
  max(0, -k_ij, -k_ji) off the diagonal with zero row sums, plus the
  face fluxes lumped by rows, over the lumped mass;
- FCT, FluxBased with one sweep (remhos_fct.cpp:295-446): d_ij =
  max(0, -K_HO_ij, -K_HO_ji) over the whole sparsity of K_HO, the
  own-neighbour blocks included (they come out 0 on this basis, and are
  carried through the sweep all the same), the antidiffusive fluxes
  f_ij = dt d_ij (u_i - u_j) + dt M_ij (du_HO_i - du_HO_j), Zalesak's
  limiting factors against the `-bt 0` overlap bounds (the extrema over
  the elements that share a dof's Gauss-Lobatto node);
- RK3-SSP in MFEM's form, with the full dt as every stage's limiter dt,
  and no mass closure.

It imports nothing of the measured program and takes nothing it made: the
mesh, the mesh velocity, the bases and every table are built here from the
sizes alone. (It cannot share `remap.py`'s tables: the harness loads a
reference by its path, outside any package.)

Precision: `dtype` float64 is the reference. The control of the benchmark
runs the same code in float32, with `tf32=True` also every matrix
product's operands rounded to TF32's 10-bit mantissa.
"""

from __future__ import annotations

import math
from math import comb

import numpy as np
import torch

# the faces of a hex as (axis, side), MFEM's order
FACES = ((2, 0), (1, 0), (0, 1), (1, 1), (0, 0), (2, 1))


# ---------------------------------------------------------------------------
# 1D bases (host numpy, float64) and their tensor products
# ---------------------------------------------------------------------------

def gauss_legendre(n):
    x, w = np.polynomial.legendre.leggauss(n)
    return 0.5 * (x + 1.0), 0.5 * w


def gauss_lobatto(n):
    """n Gauss-Lobatto points on [0, 1]."""
    inner = np.polynomial.legendre.Legendre.basis(n - 1).deriv().roots()
    return 0.5 * (np.concatenate([[-1.0], np.sort(inner.real), [1.0]]) + 1)


def bernstein(p, x):
    """(values, derivatives) [len(x), p+1] of the Bernstein basis."""
    x = np.asarray(x, np.float64)

    def vals(q):
        i = np.arange(q + 1)
        c = np.array([comb(q, k) for k in i], np.float64)
        return c * x[:, None] ** i * (1.0 - x[:, None]) ** (q - i)

    low = vals(p - 1)
    d = np.zeros((len(x), p + 1))
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


def lex(n1):
    """[n1^3, 3] multi-indices, axis 0 fastest."""
    g = np.meshgrid(*[np.arange(n1)] * 3, indexing="ij")
    return np.stack([a.ravel(order="F") for a in g], -1)


# ---------------------------------------------------------------------------
# the mesh, the space and the mesh velocity
# ---------------------------------------------------------------------------

class Space:
    """An n^3 Cartesian mesh of [0, 1]^3 (not periodic) with mesh order 2
    (Gauss-Lobatto nodes), the order-p Bernstein DG space on it, and the
    volume and face rules of MFEM's mass, convection and DG trace
    integrators (order 2p + 3 mesh_order - 1). Element e = ix + n iy +
    n^2 iz; dofs, nodes and points axis 0 fastest. Tables are float64
    tensors on `device`."""

    def __init__(self, n, p, device="cpu", mesh_order=2):
        self.n, self.device = n, device
        self.E = n ** 3
        n1 = p + 1
        self.nd, self.fd = n1 ** 3, n1 ** 2
        gll = gauss_lobatto(mesh_order + 1)
        ref = gll[lex(mesh_order + 1)]                         # [nm, 3]
        self.x0 = self._T((lex(n)[:, None, :] + ref[None]) / n)
        q1, w1 = gauss_legendre((2 * p + 3 * mesh_order - 1) // 2 + 1)
        B1, G1 = bernstein(p, q1)
        M1, MG1 = lagrange(gll, q1)
        self.w_q = self._T(kron([w1[:, None]] * 3)[:, 0])      # [Q]
        self.Bu = self._T(kron([B1] * 3))                      # [Q, nd]
        self.Gu = self._T(np.stack(                            # [Q, nd, 3]
            [kron([G1 if a == b else B1 for a in range(3)])
             for b in range(3)], -1))
        self.Bm = self._T(kron([M1] * 3))                      # [Q, nm]
        self.Gm = self._T(np.stack(                            # [Q, nm, 3]
            [kron([MG1 if a == b else M1 for a in range(3)])
             for b in range(3)], -1))
        # the face rule: the volume rule's points on the two tangential
        # axes, in increasing axis order (as the face dofs)
        self.w_fq = self._T(kron([w1[:, None]] * 2)[:, 0])     # [Qf]
        self.Bface = self._T(kron([B1] * 2))                   # [Qf, fd]
        midx = lex(n1)
        Bmf, Gt, sign, bdr = [], [], [], []
        for axis, side in FACES:
            Me = lagrange(gll, np.array([float(side)]))[0]
            Bmf.append(kron([Me if a == axis else M1 for a in range(3)]))
            # the tangents d x / d xi along the next two axes, cyclically:
            # their cross product points along +axis
            Gt.append(np.stack([kron([MG1 if a == b else
                                      (Me if a == axis else M1)
                                      for a in range(3)])
                                for b in ((axis + 1) % 3, (axis + 2) % 3)],
                               -1))
            sign.append(1.0 if side == 1 else -1.0)
            # the element's dofs on the face, tangential lex order
            sel = np.where(midx[:, axis] == (p if side else 0))[0]
            t0, t1 = [a for a in range(3) if a != axis]
            key = midx[sel, t0] + n1 * midx[sel, t1]
            bdr.append(sel[np.argsort(key, kind="stable")])
        self.Bmf, self.Gmf_tan = self._T(np.stack(Bmf)), self._T(np.stack(Gt))
        self.face_sign = self._T(np.array(sign))
        bdr = np.stack(bdr)
        self.opp = [FACES.index((a, 1 - s)) for a, s in FACES]
        self.bdr = torch.as_tensor(bdr, device=device)         # [nf, fd]
        self.nbr_dof = torch.as_tensor(bdr[self.opp], device=device)
        # the closed-uniform points whose values are the Bernstein dofs of
        # a projected function (MFEM's PositiveFiniteElement::Project)
        un = np.linspace(0.0, 1.0, n1)
        self.Bm_unodes = self._T(kron([lagrange(gll, un)[0]] * 3))
        # per axis, each dof's position class: 0 low end, 1 interior, 2 high
        # end (which neighbours share its Gauss-Lobatto node)
        self.dof_class = [tuple(c) for c in
                          np.where(midx == 0, 0, np.where(midx == p, 2, 1))]

    def _T(self, a):
        return torch.as_tensor(np.asarray(a, np.float64), device=self.device)

    def bernstein_points(self):
        """[E, nd, 3] positions whose function values are the Bernstein
        coefficients of the projection."""
        return torch.einsum("emd,nm->end", self.x0, self.Bm_unodes)

    def from_nbr(self, a, axis, side, edge=None):
        """b[e] = a[the neighbour of e across the face (axis, side)] for a
        per-element a[E, ...]; on the boundary 0, or with `edge` a itself
        (the element is its own neighbour)."""
        n = self.n
        g = a.reshape((n, n, n) + a.shape[1:])
        d = 2 - axis                        # the grid is [iz, iy, ix, ...]
        pad = (torch.zeros_like(g.narrow(d, 0, 1)) if edge is None
               else g.narrow(d, n - 1 if side else 0, 1))
        if side == 1:
            g = torch.cat([g.narrow(d, 1, n - 1), pad], d)
        else:
            g = torch.cat([pad, g.narrow(d, 0, n - 1)], d)
        return g.reshape(a.shape)


def taylor_green(x):
    """Remap problem 10's mesh velocity (Taylor-Green) on [0, 1]^3."""
    v0 = torch.sin(math.pi * x[..., 0]) * torch.cos(math.pi * x[..., 1])
    v1 = -torch.cos(math.pi * x[..., 0]) * torch.sin(math.pi * x[..., 1])
    cz = torch.cos(math.pi * x[..., 2])
    return torch.stack([v0 * cz, v1 * cz, torch.zeros_like(v0)], -1)


def mesh_velocity(x0, dt, t_final=0.7):
    """v = x(t_final) - x0, the nodes moved by forward Euler steps of dt
    through the velocity field (remhos.cpp:560-584, with its last-step
    rule)."""
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


def _upwinding(K):
    """d[E, n, n] = max(0, -k_ij, -k_ji) off the diagonal, 0 on it."""
    d = torch.maximum((-K).clamp(min=0.0), -K.transpose(1, 2))
    eye = torch.eye(K.shape[-1], dtype=torch.bool, device=K.device)
    return torch.where(eye, 0.0, d)


class RemapFA:
    """The stage and the phase of `-ho 3 -lo 1 -fct 1 -bt 0` on `space`.
    dtype float64 (the reference) or float32; tf32 rounds every product's
    operands to TF32 (the control)."""

    def __init__(self, space, v, dtype=torch.float64, tf32=False):
        if tf32 and dtype != torch.float32:
            raise ValueError("tf32 rounds float32 operands")
        sp = self.sp = space
        self.dtype, self.tf32 = dtype, tf32

        def C(a):
            return a.to(dtype)

        self.x0, self.v = C(sp.x0), C(v)
        self.w_q, self.Bu, self.Gm = C(sp.w_q), C(sp.Bu), C(sp.Gm)
        self.w_fq, self.Bface, self.Gt = C(sp.w_fq), C(sp.Bface), C(sp.Gmf_tan)
        Q, nd, _ = sp.Gu.shape
        # K_ij = sum_{q, b} (w_q va_b)[q] (Bu_i Gu_jb)[q]: one product with
        # this [3 Q, nd^2] table
        self.BG = C((sp.Bu[:, :, None, None] * sp.Gu[:, None, :, :])
                    .permute(3, 0, 1, 2).reshape(3 * Q, nd * nd))
        # M_ij = sum_q (w_q det J)[q] (Bu_i Bu_j)[q]
        self.BB = C((sp.Bu[:, :, None] * sp.Bu[:, None, :]).reshape(Q, -1))
        fd = sp.fd
        self.FF = C((sp.Bface[:, :, None] * sp.Bface[:, None, :])
                    .reshape(-1, fd * fd))
        # the velocity does not depend on t: at the volume and face points
        nf, Qf, nm = sp.Bmf.shape
        self.v_q = self._interp(self.v, C(sp.Bm))              # [E, Q, 3]
        self.v_fq = self._interp(self.v, C(sp.Bmf).reshape(nf * Qf, nm)
                                 ).reshape(sp.E, nf, Qf, 3)

    def mm(self, a, b):
        if self.tf32:
            return _tf32(a) @ _tf32(b)
        return a @ b

    def _interp(self, x, Bt):
        """x[E, nm, 3] at points: Bt[P, nm] -> [E, P, 3]."""
        E, nm, _ = x.shape
        y = self.mm(x.transpose(1, 2).reshape(E * 3, nm), Bt.T)
        return y.reshape(E, 3, -1).transpose(1, 2)

    def matvec(self, A, u):
        """(A u)[E, n] of element blocks A[E, n, m] and u[E, m]."""
        return self.mm(A, u[:, :, None])[:, :, 0]

    # -- the element matrices at the stage time ------------------------------

    def assemble(self, t):
        """{M, ml, K (volume), B (the upwind face mass of each face)
        [E, nf, fd, fd], K_own (K_HO's element block), X (K_HO's
        own-neighbour block of each face, 0 on the boundary)
        [E, nf, fd, fd]} at the nodes x0 + t v."""
        sp = self.sp
        x = self.x0 + t * self.v
        E, nm, _ = x.shape
        A = x.transpose(1, 2).reshape(E * 3, nm)
        # J[d][b] = dx_d / dxi_b at the volume points, each [E, Q]
        cols = [self.mm(A, self.Gm[:, :, b].T).reshape(E, 3, -1)
                for b in range(3)]
        J = [[cols[b][:, d] for b in range(3)] for d in range(3)]
        cof = [[J[(d + 1) % 3][(b + 1) % 3] * J[(d + 2) % 3][(b + 2) % 3]
                - J[(d + 1) % 3][(b + 2) % 3] * J[(d + 2) % 3][(b + 1) % 3]
                for b in range(3)] for d in range(3)]
        wdet = self.w_q * sum(J[0][b] * cof[0][b] for b in range(3))
        # (w_q adj(J) v)_b = w_q sum_d cof[d][b] v_d
        wva = torch.cat([self.w_q * sum(cof[d][b] * self.v_q[..., d]
                                        for d in range(3))
                         for b in range(3)], 1)                # [E, 3 Q]
        del J, cof, cols
        nd, fd = sp.nd, sp.fd
        K = self.mm(wva, self.BG).reshape(E, nd, nd)
        M = self.mm(wdet, self.BB).reshape(E, nd, nd)
        del wva
        # the scaled outward normals from the face tangents
        nf, Qf, _, _ = self.Gt.shape
        G2 = self.Gt.permute(2, 0, 1, 3).reshape(nm, nf * Qf * 2)
        Tg = self.mm(A, G2).reshape(E, 3, nf, Qf, 2).permute(0, 2, 3, 1, 4)
        nor = torch.linalg.cross(Tg[..., 0], Tg[..., 1], dim=-1)
        nor = nor * sp.face_sign.to(self.dtype)[None, :, None, None]
        wvn = self.w_fq * (self.v_fq * nor).sum(-1).clamp(min=0.0)
        B = self.mm(wvn.reshape(E * nf, Qf), self.FF).reshape(E, nf, fd, fd)
        # K_HO's own-own terms: -B at each face's dof pairs (an edge or a
        # corner pair lies on several faces and accumulates)
        K_own = K.clone()
        for f in range(nf):
            idx = sp.bdr[f]
            K_own[:, idx[:, None], idx[None, :]] -= B[:, f]
        X = torch.stack([self._interior(B[:, f], f) for f in range(nf)], 1)
        return dict(M=M, ml=M.sum(2), K=K, B=B, K_own=K_own, X=X)

    def _interior(self, a, f):
        """a[E, ...] on the interior faces f, 0 on the boundary ones."""
        axis, side = FACES[f]
        inside = self.sp.from_nbr(torch.ones(self.sp.E, device=a.device),
                                  axis, side) > 0
        return torch.where(inside.reshape((-1,) + (1,) * (a.dim() - 1)),
                           a, 0.0)

    def nbr_faces(self, a):
        """a[E, nd] at the neighbour's dofs across each face, in the order
        of the element's own face dofs [E, nf, fd]; 0 on the boundary."""
        sp = self.sp
        return torch.stack([sp.from_nbr(a[:, sp.nbr_dof[f]], axis, side)
                            for f, (axis, side) in enumerate(FACES)], 1)

    def scatter(self, contrib):
        """contrib[E, nf, fd] added into [E, nd] at the face dofs."""
        sp = self.sp
        out = torch.zeros(contrib.shape[0], sp.nd, dtype=contrib.dtype,
                          device=contrib.device)
        return out.index_add(1, sp.bdr.reshape(-1),
                             contrib.reshape(contrib.shape[0], -1))

    # -- the solvers ---------------------------------------------------------

    def ho(self, g, u):
        """LocalInverse: M^-1 K_HO u."""
        cross = self.mm(g["X"], self.nbr_faces(u)[..., None])[..., 0]
        rhs = self.matvec(g["K_own"], u) + self.scatter(cross)
        return torch.linalg.solve(g["M"], rhs[:, :, None])[:, :, 0]

    def lo(self, g, u):
        """DiscreteUpwind: (D u + the row-lumped face fluxes) / ml, D = K +
        d on the volume matrix."""
        K = g["K"]
        d = _upwinding(K)
        Du = self.matvec(K, u) + self.matvec(d, u) - d.sum(2) * u
        face = g["B"].sum(3) * (self.nbr_faces(u) - u[:, self.sp.bdr])
        return (Du + self.scatter(face)) / g["ml"]

    def bounds(self, u):
        """The `-bt 0` overlap bounds (u_min, u_max) [E, nd]: at each dof the
        extremum of u over the elements that share its Gauss-Lobatto node,
        one axis at a time."""
        sp = self.sp
        out = []
        for red, el in ((torch.minimum, u.amin(1)),
                        (torch.maximum, u.amax(1))):
            cls = {(): el}
            for axis in range(3):
                nxt = {}
                for key, h in cls.items():
                    nxt[key + (0,)] = red(h, sp.from_nbr(h, axis, 0, True))
                    nxt[key + (1,)] = h
                    nxt[key + (2,)] = red(h, sp.from_nbr(h, axis, 1, True))
                cls = nxt
            out.append(torch.stack([cls[c] for c in sp.dof_class], 1))
        return out

    def d_cross(self, X):
        """d_ij = max(0, -K_HO_ij, -K_HO_ji) of each face's own-neighbour
        block [E, nf, fd, fd] (0 on the boundary): K_HO_ij = X[e, f, a, b],
        K_HO_ji the neighbour's block of the opposite face, transposed."""
        sp = self.sp
        out = []
        for f, (axis, side) in enumerate(FACES):
            X_ji = sp.from_nbr(X[:, sp.opp[f]], axis, side).transpose(1, 2)
            out.append(self._interior(
                torch.maximum((-X[:, f]).clamp(min=0.0), -X_ji), f))
        return torch.stack(out, 1)

    def fct(self, g, u, du_ho, du_lo, dt):
        """FluxBased FCT, one Zalesak sweep, over the element blocks and the
        own-neighbour face blocks of K_HO's sparsity. Every flux is 0 on the
        diagonal (u_i - u_i, du_i - du_i)."""
        sp = self.sp
        u_min, u_max = self.bounds(u)
        F = dt * _upwinding(g["K_own"]) * (u[:, :, None] - u[:, None, :]) \
            + dt * g["M"] * (du_ho[:, :, None] - du_ho[:, None, :])
        Fx = dt * self.d_cross(g["X"]) * (u[:, sp.bdr][..., None]
                                          - self.nbr_faces(u)[:, :, None, :])
        m = g["ml"]
        gp = F.clamp(min=0.0).sum(2) + self.scatter(Fx.clamp(min=0.0).sum(3))
        gm = F.clamp(max=0.0).sum(2) + self.scatter(Fx.clamp(max=0.0).sum(3))
        u_lo = u + dt * du_lo
        max_pos = ((u_max - u_lo) * m).clamp(min=0.0)
        min_neg = ((u_min - u_lo) * m).clamp(max=0.0)
        cp = torch.where(gp > max_pos, max_pos / gp, 1.0)
        cn = torch.where(gm < min_neg, min_neg / gm, 1.0)
        a = torch.where(F >= 0.0,
                        torch.minimum(cp[:, :, None], cn[:, None, :]),
                        torch.minimum(cn[:, :, None], cp[:, None, :]))
        cp_f, cn_f = cp[:, sp.bdr], cn[:, sp.bdr]
        cp_n, cn_n = self.nbr_faces(cp), self.nbr_faces(cn)
        ax = torch.where(Fx >= 0.0,
                         torch.minimum(cp_f[..., None], cn_n[:, :, None, :]),
                         torch.minimum(cn_f[..., None], cp_n[:, :, None, :]))
        limited = (a * F).sum(2) + self.scatter((ax * Fx).sum(3))
        return du_lo + limited / m / dt

    def stage(self, t, dt, u):
        """The limited rate du[E, nd] of u at time t."""
        g = self.assemble(t)
        du_ho = self.ho(g, u)
        du_lo = self.lo(g, u)
        return self.fct(g, u, du_ho, du_lo, dt)

    def ml(self, t):
        """The lumped mass ml[E, nd] at time t."""
        return self.assemble(t)["ml"]

    def phase(self, S0, steps, dt):
        """`steps` RK3-SSP steps from S0[1, E, nd] at t = 0 (MFEM's
        RK3SSPSolver, every stage limited with dt). Returns the final
        state [1, E, nd]."""
        u = S0[0].to(self.dtype)
        t = 0.0
        for _ in range(steps):
            k = self.stage(t, dt, u)
            y = u + dt * k
            k = self.stage(t + dt, dt, y)
            y = 0.75 * u + 0.25 * (y + dt * k)
            k = self.stage(t + dt / 2, dt, y)
            u = u / 3.0 + 2.0 / 3.0 * (y + dt * k)
            t += dt
        return u[None]


# ---------------------------------------------------------------------------
# the interface the harness finds by a configuration's "reference" key
# ---------------------------------------------------------------------------

def _supported(config):
    """Raise unless this reference computes what `config` asks for."""
    s = config["solver"]
    want = dict(problem=10, ho=3, lo=1, fct=1, ode_solver=3, bounds_type=0,
                pa=False, product_sync=False)
    off = {k: s.get(k) for k in want if s.get(k) != want[k]}
    if (off or config.get("mesh") != "cartesian" or config.get("dim") != 3
            or config.get("mesh_order") != 2):
        raise ValueError(f"perfbench/reference/remap_fa.py computes -p 10 "
                         f"-ho 3 -lo 1 -fct 1 -bt 0 -s 3 without -pa on a "
                         f"Cartesian hex mesh of mesh order 2; the "
                         f"configuration asks {off or config}")


def points(config, traffic, device):
    """[E, nd, 3] float64: the points whose field values are the Bernstein
    coefficients of the cell's initial field."""
    _supported(config)
    return Space(traffic["n"], config["order"], device).bernstein_points()


class Reference:
    """A cell's phase in the reference: `phase(S0)` the final state,
    `mass(t, u)` the mass of u in the lumped mass at pseudo-time t (float64,
    cached per t), `t_end` the pseudo-time a phase ends at. dtype and tf32
    as `RemapFA`'s (the control)."""

    def __init__(self, config, traffic, device, dtype=torch.float64,
                 tf32=False):
        _supported(config)
        sp = Space(traffic["n"], config["order"], device)
        self.steps, self.dt = traffic["steps_per_remap"], traffic["dt"]
        self.t_end = self.steps * self.dt
        v = mesh_velocity(sp.x0, self.dt, config["mesh_t_final"])
        self.op = RemapFA(sp, v, dtype=dtype, tf32=tf32)
        self._ml = {}

    def phase(self, S0):
        return self.op.phase(S0, self.steps, self.dt)

    def mass(self, t, u):
        if t not in self._ml:
            self._ml[t] = self.op.ml(t).double()
        return float((self._ml[t] * u.double()).sum())
