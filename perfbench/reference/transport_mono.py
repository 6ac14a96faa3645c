"""The plain reference of a transport phase of Remhos's monolithic
residual-distribution solver with the smoothness indicator: the benchmark's
yardstick of `correct` for `-p 7 -o 1 -mono 1 -si 2` (the CI's
`steady-mono2` row).

Transport problem 7 on an n^2 Cartesian quad mesh of [0, 1]^2 (not
periodic), order-1 Bernstein DG, written as plain PyTorch from the
discretization up on the structured grid of elements:

- the element matrices, once (the mesh stands still): the mass M
  (MassIntegrator), its row sums ml, and the volume convection of
  transport, K_ij = -int phi_i (v . grad phi_j) (ConvectionIntegrator(v,
  -1)); for each face the upwind block B_ij = int phi_i phi_j max(0,
  -v.n) over the face (DGTraceIntegrator's inflow side), with the rotating
  velocity v = (y, -x);
- problem 7's inflow: the smooth tanh ring of r = |x|, taken at the
  element's Gauss-Legendre points and extrapolated to its corners (the
  Gauss-Legendre nodal interpolant, read as Bernstein coefficients,
  remhos.cpp:626-636), the neighbour value on the physical boundary;
- the `-bt 0` bounds: at each dof the extrema of u over the elements that
  share its vertex;
- the `-si 2` indicator (SmoothnessIndicator, remhos_tools.cpp:24-354) on
  the vertex grid: the Q1 mass of the DG values assembled at the vertices,
  two two-term Neumann inversions of the assembled Q1 mass (around the
  Q1 Laplacian with its boundary term, DiffusionIntegrator(-1) plus the
  boundary part of DGDiffusionIntegrator(-1, 0, 0)), the 3 x 3 vertex
  extrema g_min, g_max, and 3 max(0, g_min g_max) / (max(g_min^2, g_max^2)
  + 1e-15), at most 1; 1 at the vertices of the domain boundary;
- the explicit part of MonoRDSolver::CalcSolution (remhos_mono.cpp:
  60-260): z = K u, the per-dof limiters alpha with the indicator's
  relaxed bounds, du = alpha z, the face terms by the nonlinear flux
  lumping with alpha (NonlinFluxLumping, remhos_tools.cpp:915-973: the
  lumped flux plus the high-order correction, rescaled per face so that its
  parts cancel), and the residual distribution of (1 - alpha) z with
  weights (x_max - u_i) / (nd x_max - sum u) and (x_min - u_i) / (nd x_min
  - sum u); the rate du / ml;
- RK3-SSP in MFEM's form.

Departures from the source: the consistent-mass inner loop
(remhos_mono.cpp:262-348) is left out, as Remhos leaves it out for
problem 7 (remhos.cpp:999), so the unlimited fluctuations that only it
reads are not formed; the Neumann inversions' residual test
(remhos_tools.cpp:269-293) is a test of the global 2-norm, as the
solver's serial run makes it. The element integrals use 3 Gauss points an
axis, exact for every integrand here.

It imports nothing of the measured program and takes nothing it made.
Precision: `dtype` float64 is the reference; the control of the benchmark
runs the same code in float32, with `tf32=True` also every matrix
product's operands rounded to TF32's 10-bit mantissa.
"""

from __future__ import annotations

import numpy as np
import torch

BETA = 10.0            # the limiters' factor (remhos_mono.cpp)
EPS = 1.0e-15          # guards of the limiters and the weights
SI_POWER = 3.0         # -si 2's factor
SI_EPS = 1.0e-15
NEUMANN_TOL = 1.0e-10
# the faces of a quad as (axis, side); axis 0 is x
FACES = ((0, 0), (0, 1), (1, 0), (1, 1))


def _tf32(a):
    """a (float32) with its mantissa rounded to TF32's 10 bits, to the
    nearest, ties to even."""
    i = a.contiguous().view(torch.int32)
    i = (i + 0x0FFF + ((i >> 13) & 1)) & ~0x1FFF
    return i.view(torch.float32)


def velocity(x, y):
    """Problem 7's steady rotating flow v = (y, -x)."""
    return y, -x


def tanh_ring(r):
    """Problem 7's profile (its u0 and its inflow) at radius r."""
    a, b, c = 0.5, 3.0e-2, 0.1
    return 0.25 * (1.0 + torch.tanh((r + c - a) / b)) \
        * (1.0 - torch.tanh((r - c - a) / b))


def gauss_legendre(k):
    x, w = np.polynomial.legendre.leggauss(k)
    return 0.5 * (x + 1.0), 0.5 * w


def q1(x):
    """Values [len(x), 2] of the linear Bernstein basis (1 - x, x)."""
    x = np.asarray(x, np.float64)
    return np.stack([1.0 - x, x], -1)


# the order-1 derivatives of (1 - x, x)
DQ1 = np.array([-1.0, 1.0])


def face_dofs(axis, side):
    """The element's dofs (i0 + 2 i1) on the face (axis, side), by the
    index along the other axis."""
    return [side + 2 * t for t in (0, 1)] if axis == 0 else \
        [t + 2 * side for t in (0, 1)]


class Grid:
    """n^2 elements of width h; element e = ix + n iy, dof i = i0 + 2 i1
    (the corner at (ix + i0, iy + i1) h); per-element arrays [E, ...]."""

    def __init__(self, n, device="cpu"):
        self.n, self.h, self.E, self.device = n, 1.0 / n, n * n, device
        i = torch.arange(n, dtype=torch.float64, device=device)
        self.iy, self.ix = [a.reshape(-1) for a in
                            torch.meshgrid(i, i, indexing="ij")]

    def corners(self):
        """[E, 4, 2] the dofs' positions: the Bernstein coefficients of a
        projection are the values there."""
        c = torch.tensor([[0., 0.], [1., 0.], [0., 1.], [1., 1.]],
                         dtype=torch.float64, device=self.device)
        return (torch.stack([self.ix, self.iy], -1)[:, None, :] + c) * self.h

    def nbr(self, a, axis, side, fill):
        """b[e] = a[the neighbour of e across (axis, side)], fill[e] where
        e lies on that side of the domain; a and fill [E, ...]."""
        n = self.n
        g = a.reshape((n, n) + a.shape[1:])
        f = fill.reshape(g.shape)
        d = 1 - axis                     # the grid is [iy, ix, ...]
        if side == 1:
            out = torch.cat([g.narrow(d, 1, n - 1), f.narrow(d, n - 1, 1)],
                            d)
        else:
            out = torch.cat([f.narrow(d, 0, 1), g.narrow(d, 0, n - 1)], d)
        return out.reshape(a.shape)

    def on_boundary(self, axis, side):
        """[E] bool: the element's face (axis, side) is on the boundary."""
        i = self.ix if axis == 0 else self.iy
        return i == (self.n - 1 if side else 0)

    # -- the vertex grid [(n + 1)^2], vertex (a, b) at (a h, b h) ----------

    def to_vertices(self, c):
        """The sum at each vertex of the element contributions c[E, 4]."""
        n = self.n
        g = c.reshape(n, n, 2, 2)              # [iy, ix, i1, i0]
        out = c.new_zeros(n + 1, n + 1)
        for i1 in (0, 1):
            for i0 in (0, 1):
                out[i1:i1 + n, i0:i0 + n] += g[:, :, i1, i0]
        return out

    def from_vertices(self, v):
        """[E, 4]: each dof's vertex value of v[(n + 1), (n + 1)]."""
        n = self.n
        parts = [v[i1:i1 + n, i0:i0 + n] for i1 in (0, 1) for i0 in (0, 1)]
        return torch.stack(parts, -1).reshape(self.E, 4)

    def vertex_extrema(self, v, red, pad):
        """red over each vertex's 3 x 3 vertex neighbourhood."""
        n1 = self.n + 1
        p = torch.full((n1 + 2, n1 + 2), pad, dtype=v.dtype,
                       device=v.device)
        p[1:-1, 1:-1] = v
        out = v
        for a in range(3):
            for b in range(3):
                out = red(out, p[a:a + n1, b:b + n1])
        return out

    def element_extrema_at_dofs(self, el, red, pad):
        """[E, 4]: red of the per-element el[E] over the elements that
        share each dof's vertex."""
        n = self.n
        p = torch.full((n + 2, n + 2), pad, dtype=el.dtype,
                       device=el.device)
        p[1:-1, 1:-1] = el.reshape(n, n)
        v = red(red(p[:-1, :-1], p[:-1, 1:]), red(p[1:, :-1], p[1:, 1:]))
        return self.from_vertices(v)


class TransportMono:
    """The stage and the phase of `-p 7 -o 1 -mono 1 -si 2 -bt 0` on
    `grid`. dtype float64 (the reference) or float32; tf32 rounds every
    product's operands to TF32 (the control)."""

    def __init__(self, grid, dtype=torch.float64, tf32=False):
        if tf32 and dtype != torch.float32:
            raise ValueError("tf32 rounds float32 operands")
        self.g, self.dtype, self.tf32 = grid, dtype, tf32
        g, h, dev = grid, grid.h, grid.device
        xq, wq = gauss_legendre(3)
        b, db = q1(xq), np.tile(DQ1, (len(xq), 1))
        m1 = np.einsum("q,qa,qb->ab", wq, b, b)
        k1 = np.einsum("q,qa,qb->ab", wq, db, db)

        def T(a):
            return torch.as_tensor(np.asarray(a, np.float64), device=dev)

        def prod(fx, fy):
            """[i, j] = fx[i0, j0] fy[i1, j1], i = i0 + 2 i1."""
            return np.kron(fy, fx)

        # the element mass and its lumped form (the mesh is uniform)
        M = h * h * prod(m1, m1)
        self.M = T(M).to(dtype)
        self.ml = T(M.sum(1)).to(dtype)
        # K = -h sum_q w phi_i (vx d_xi phi_j + vy d_eta phi_j): one product
        # of the velocity at the points [E, Q] with tables [Q, 16]
        W = np.kron(wq, wq)                                 # [Q] (r, q)
        Phi = np.kron(b, b)                                 # [Q, 4]
        Gx = np.kron(b, db)                                 # d/dxi
        Gy = np.kron(db, b)                                 # d/deta
        Tx = (W[:, None, None] * Phi[:, :, None] * Gx[:, None, :])
        Ty = (W[:, None, None] * Phi[:, :, None] * Gy[:, None, :])
        X = (g.ix[:, None] + T(np.tile(xq, len(xq)))[None]) * h
        Y = (g.iy[:, None] + T(np.repeat(xq, len(xq)))[None]) * h
        vx, vy = velocity(X, Y)
        self.K = -h * (self.mm(vx.to(dtype), T(Tx.reshape(9, 16)).to(dtype))
                       + self.mm(vy.to(dtype),
                                 T(Ty.reshape(9, 16)).to(dtype))
                       ).reshape(g.E, 4, 4)
        del X, Y, vx, vy
        # the upwind face blocks [E, 4 faces, 2, 2] and the inflow values
        FF = T(np.einsum("q,qa,qb->qab", wq, b, b).reshape(3, 4)).to(dtype)
        blocks = []
        for axis, side in FACES:
            s = T(xq)[None]
            if axis == 0:
                x, y = (g.ix[:, None] + side) * h, (g.iy[:, None] + s) * h
            else:
                x, y = (g.ix[:, None] + s) * h, (g.iy[:, None] + side) * h
            v = velocity(x, y)[axis]
            vn = v if side == 1 else -v
            up = h * (-vn).clamp(min=0.0)                   # [E, 3]
            blocks.append(self.mm(up.to(dtype), FF).reshape(g.E, 2, 2))
        self.B = torch.stack(blocks, 1)
        self.inflow = self._inflow().to(dtype)
        # the indicator's element blocks: the Q1 mass (M) and the Laplacian
        # -S plus the boundary term int psi_i d_n psi_j on boundary faces
        S = prod(k1 / h, h * m1) + prod(h * m1, k1 / h)
        self.Lap = T(-S).expand(g.E, 4, 4).clone()
        for axis, side in FACES:
            val = np.array([0.0, 1.0]) if side else np.array([1.0, 0.0])
            dn = (1.0 if side else -1.0) * DQ1 / h
            edge = np.outer(val, dn)
            blk = prod(edge, h * m1) if axis == 0 else prod(h * m1, edge)
            on = g.on_boundary(axis, side)
            self.Lap[on] += T(blk)
        self.Lap = self.Lap.to(dtype)
        self.lumped_v = g.to_vertices(self.ml.expand(g.E, 4))
        n = g.n
        edge = torch.zeros(n + 1, n + 1, dtype=torch.bool, device=dev)
        edge[0], edge[-1], edge[:, 0], edge[:, -1] = True, True, True, True
        self.si_fixed = g.from_vertices(edge)

    def mm(self, a, b):
        if self.tf32:
            return _tf32(a) @ _tf32(b)
        return a @ b

    def matvec(self, A, u):
        """(A u)[E, 4] of element blocks A[E, 4, 4] (or one [4, 4])."""
        if A.dim() == 2:
            return self.mm(u, A.T)
        return self.mm(A, u[:, :, None])[:, :, 0]

    def _inflow(self):
        """[E, 4] float64: problem 7's ring at the element's 2 x 2
        Gauss-Legendre points, extrapolated to its corners."""
        g, h = self.g, self.g.h
        xg, _ = gauss_legendre(2)
        # L[k, a]: the Lagrange basis through the points xg at 0 and 1
        L = np.array([[(k - xg[1 - a]) / (xg[a] - xg[1 - a]) for a in (0, 1)]
                      for k in (0.0, 1.0)])
        Tm = torch.as_tensor(np.kron(L, L), device=g.device)  # [4, 4]
        xs = torch.as_tensor(np.tile(xg, 2), device=g.device)
        ys = torch.as_tensor(np.repeat(xg, 2), device=g.device)
        x = (g.ix[:, None] + xs[None]) * h
        y = (g.iy[:, None] + ys[None]) * h
        f = tanh_ring(torch.sqrt(x * x + y * y))            # [E, 4]
        return f @ Tm.T

    def inflow_range(self):
        """(min, max) of the inflow values at the dofs of the boundary
        faces that take an inflow."""
        lo, hi = [], []
        for f, (axis, side) in enumerate(FACES):
            on = self.g.on_boundary(axis, side) & (self.B[:, f].sum((1, 2))
                                                   > 0)
            vals = self.inflow[on][:, face_dofs(axis, side)].double()
            if vals.numel():
                lo.append(float(vals.min()))
                hi.append(float(vals.max()))
        return min(lo), max(hi)

    # -- the smoothness indicator -------------------------------------------

    def _neumann(self, rhs):
        """Two terms of the Neumann series of the assembled Q1 mass:
        y <- y - (M y - rhs) / lumped, kept where the residual's 2-norm is
        at most NEUMANN_TOL."""
        y = torch.zeros_like(rhs)
        for _ in range(2):
            z = self.g.to_vertices(self.matvec(self.M, self.g.from_vertices(
                y))) - rhs
            if float(torch.sqrt((z * z).sum())) > NEUMANN_TOL:
                y = y - z / self.lumped_v
        return y

    def indicator(self, u):
        """-si 2 at the dofs [E, 4]."""
        g = self.g
        y = self._neumann(g.to_vertices(self.matvec(self.M, u)))
        y = self._neumann(g.to_vertices(self.matvec(
            self.Lap, g.from_vertices(y))))
        gmin = g.vertex_extrema(y, torch.minimum, float("inf"))
        gmax = g.vertex_extrema(y, torch.maximum, -float("inf"))
        si = (SI_POWER * (gmin * gmax).clamp(min=0.0)
              / (torch.maximum(gmin * gmin, gmax * gmax) + SI_EPS)
              ).clamp(max=1.0)
        return torch.where(self.si_fixed, 1.0, g.from_vertices(si))

    # -- the monolithic stage -------------------------------------------------

    def lumping(self, u_own, u_nbr, B, alpha):
        """NonlinFluxLumping of one face: [E, 2]."""
        xd = u_nbr - u_own
        row = B.sum(2)
        corr = (self.matvec(B, xd) - row * xd) * alpha
        pos, neg = corr.clamp(min=0.0), corr.clamp(max=0.0)
        p, q = pos.sum(1, keepdim=True), neg.sum(1, keepdim=True)
        # the side of larger sum scaled by the other's share, so that the
        # parts cancel: -q / p of each positive part where p + q > EPS (p
        # > 0 there), -p / q of each negative one where p + q < -EPS
        scale_pos = torch.where(p + q > EPS, -q / p, 1.0)
        scale_neg = torch.where(p + q < -EPS, -p / q, 1.0)
        return row * xd + (scale_neg * neg + scale_pos * pos)

    def stage(self, u):
        """The rate du[E, 4] of u."""
        g = self.g
        x_min = g.element_extrema_at_dofs(u.amin(1), torch.minimum,
                                          float("inf"))
        x_max = g.element_extrema_at_dofs(u.amax(1), torch.maximum,
                                          -float("inf"))
        t = self.indicator(u)
        z = self.matvec(self.K, u)
        up, dn = x_max - u, u - x_min
        alpha = (BETA * torch.minimum(up, dn)
                 / (torch.maximum(up, dn) + EPS)).clamp(max=1.0)
        # the indicator relaxes the bounds toward [0, 1]
        bnd_n = (t * (2.0 * u - x_max) + (1.0 - t) * x_min).clamp(min=0.0)
        bnd_p = (t * (2.0 * u - x_min) + (1.0 - t) * x_max).clamp(max=1.0)
        a_n = (BETA * (u - bnd_n) / (x_max - u + EPS)).clamp(max=1.0)
        a_p = (BETA * (bnd_p - u) / (u - x_min + EPS)).clamp(max=1.0)
        mid = x_min + x_max
        alpha = torch.where(mid > 2.0 * u + EPS, a_n,
                            torch.where(mid < 2.0 * u - EPS, a_p, alpha))
        du = alpha * z
        rest = z - alpha * z
        for f, (axis, side) in enumerate(FACES):
            own = face_dofs(axis, side)
            u_nbr = g.nbr(u[:, face_dofs(axis, 1 - side)], axis, side,
                          self.inflow[:, own])
            du[:, own] += self.lumping(u[:, own], u_nbr, self.B[:, f],
                                       alpha[:, own])
        # the residual distribution of the rest
        x_e_max, x_e_min = u.amax(1, keepdim=True), u.amin(1, keepdim=True)
        s = u.sum(1, keepdim=True)
        w_p = (x_e_max - u) / (4.0 * x_e_max - s + EPS)
        w_n = (x_e_min - u) / (4.0 * x_e_min - s - EPS)
        du = du + w_p * rest.clamp(min=0.0).sum(1, keepdim=True) \
            + w_n * rest.clamp(max=0.0).sum(1, keepdim=True)
        return du / self.ml

    def phase(self, S0, steps, dt):
        """`steps` RK3-SSP steps from S0[1, E, 4]; the final state [1, E,
        4]."""
        u = S0[0].to(self.dtype)
        for _ in range(steps):
            y = u + dt * self.stage(u)
            y = 0.75 * u + 0.25 * (y + dt * self.stage(y))
            u = u / 3.0 + 2.0 / 3.0 * (y + dt * self.stage(y))
        return u[None]


# ---------------------------------------------------------------------------
# the interface the harness finds by a configuration's "reference" key
# ---------------------------------------------------------------------------

def _supported(config):
    """Raise unless this reference computes what `config` asks for."""
    s = config["solver"]
    want = dict(problem=7, mono=1, smth_ind=2, ode_solver=3, bounds_type=0,
                pa=False, product_sync=False)
    off = {k: s.get(k) for k in want if s.get(k) != want[k]}
    if (off or config.get("mesh") != "inline-quad" or config.get("dim") != 2
            or config.get("order") != 1):
        raise ValueError(f"perfbench/reference/transport_mono.py computes "
                         f"-p 7 -o 1 -mono 1 -si 2 -bt 0 -s 3 on an n^2 "
                         f"quad mesh of the unit square; the configuration "
                         f"asks {off or config}")


def points(config, traffic, device):
    """[E, 4, 2] float64: the points whose field values are the Bernstein
    coefficients of the cell's initial field."""
    _supported(config)
    return Grid(traffic["n"], device).corners()


class Reference:
    """A cell's phase in the reference: `phase(S0)` the final state,
    `mass(t, u)` the mass of u in the lumped mass (float64; the mesh stands
    still), `t_end` the time a phase ends at, `inflow_range()` the range of
    the inflow values. dtype and tf32 as `TransportMono`'s (the control)."""

    def __init__(self, config, traffic, device, dtype=torch.float64,
                 tf32=False):
        _supported(config)
        # float32 products in float32: the control asks for TF32 itself
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.steps, self.dt = traffic["steps_per_remap"], traffic["dt"]
        self.t_end = self.steps * self.dt
        self.op = TransportMono(Grid(traffic["n"], device), dtype=dtype,
                                tf32=tf32)
        self._inflow_range = self.op.inflow_range()

    def phase(self, S0):
        return self.op.phase(S0, self.steps, self.dt)

    def mass(self, t, u):
        return float((self.op.ml.double() * u.double()).sum())

    def inflow_range(self):
        return self._inflow_range
