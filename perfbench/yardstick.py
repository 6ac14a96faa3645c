"""The least work of the measured kernels and stages, from the cell's sizes.

A frozen copy of the program's own arithmetic of bytes and operations
(its cost model of the stage kernels and of the fused stage's bytes),
rewritten to take the cell's sizes (n, p, dim, mesh order, dtype) and not
the program's tables, so a later change of the program moves neither the
yardstick nor the count: the count is the same whatever does the work.

Bytes count each input read once and each output written once; operations
count 2 per multiply-add with every tensor-product contraction at its
sum-factorized size, plus the pointwise work. The least time is the larger
of bytes over the memory rate and operations over the peak rate.
"""

from __future__ import annotations

import dataclasses

# NVIDIA H100 SXM data sheet, at the full 700 W: HBM3 rate and the float32
# rate outside the tensor cores (float64 through DMMA is the same)
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = 67e12
INT32 = 4
# the fused stage's Jacobi sweeps in each precision (one reaches float32
# round-off from the D^-1 b start, eight reach float64's)
SWEEPS = {4: 1, 8: 8}
# the packed 1D tables of the stage kernels: 7 of [Q1, D] and A1 [D, D]
N_SF_QD = 7


@dataclasses.dataclass(frozen=True)
class Sizes:
    """The shapes of a cell: an n^dim hex mesh of mesh order `mesh_order`,
    order-p Bernstein DG, the volume and face rules of order
    2p + mesh_order dim - 1, and `itemsize` bytes a float."""

    n: int
    p: int
    dim: int = 3
    mesh_order: int = 2
    itemsize: int = 4

    @property
    def E(self):
        return self.n ** self.dim

    @property
    def D(self):
        return self.p + 1

    @property
    def nd(self):
        return self.D ** self.dim

    @property
    def Q1(self):
        return (2 * self.p + self.mesh_order * self.dim - 1) // 2 + 1

    @property
    def Q(self):
        return self.Q1 ** self.dim

    @property
    def Qf(self):
        return self.Q1 ** (self.dim - 1)

    @property
    def nf(self):
        return 2 * self.dim

    @property
    def fd(self):
        return self.D ** (self.dim - 1)

    @property
    def m1(self):
        return self.mesh_order + 1

    @property
    def nm(self):
        return self.m1 ** self.dim


def least_seconds(nbytes, flops):
    return max(nbytes / PEAK_BYTES_PER_S, flops / PEAK_FLOPS)


def tensor_macs(n, q, d):
    """Multiply-adds of one sum-factorized contraction between n^d and q^d
    values, one direction at a time."""
    lo, hi = min(n, q), max(n, q)
    return sum(hi ** k * lo ** (d - k + 1) for k in range(1, d + 1))


def gradient_macs(n, q, dim):
    """Multiply-adds of all dim reference derivatives of one field from
    n^dim values to q^dim points, axis by axis with shared partials."""
    mac = sum((k + 2) * q ** (k + 1) * n ** (dim - k - 1) * n
              for k in range(dim - 1))
    return mac + dim * q ** dim * n


def _core_work(s, n_cg):
    """(multiply-adds, pointwise ops) per element of the stage core: the
    reference gradients, the volume and face parts of K u, the face traces
    and, with n_cg sweeps, the Jacobi mass inverse."""
    vol = tensor_macs(s.D, s.Q1, s.dim)
    face = s.nf * tensor_macs(s.D, s.Q1, s.dim - 1)
    mac = s.dim * vol + vol + 3 * face
    pointwise = 2 * s.dim * s.Q + 3 * s.nf * s.Qf
    if n_cg > 0:
        mac += 2 * tensor_macs(s.D, s.D, s.dim) + vol + n_cg * 2 * vol
        pointwise += n_cg * (s.Q + 3 * s.nd) + 2 * s.nd
    return mac, pointwise


def poly_width(s):
    """Floats per element of the fused stage's geometry polynomials: va
    (dim coefficients of dim components), w_q det J (dim + 1) and v.n
    (dim) at the volume and face points."""
    return (s.dim * s.dim + s.dim + 1) * s.Q + s.dim * s.nf * s.Qf


def fused_stage_kernel(s):
    """(bytes, flops) of the fused limited stage (kernel 1, the class-major
    bounds stencil): u, the neighbour trace, the two [3^dim] stencils and
    du per element, the geometry polynomials, the packed 1D tables and the
    int32 face and class tables read or written once; the core, the Horner
    evaluations, the lumped mass, the MassBasedAvg average and ClipScale."""
    per_el = 2 * s.nd + s.nf * s.fd + 2 * 3 ** s.dim
    tables = ((N_SF_QD * s.Q1 * s.D + s.D * s.D) * s.itemsize
              + (s.nf * s.fd + s.nd * s.dim + s.nd) * INT32)
    nbytes = s.E * (per_el + poly_width(s)) * s.itemsize + tables
    mac, pointwise = _core_work(s, SWEEPS[s.itemsize])
    mac += (s.Q * s.dim * (s.dim - 1) + s.Q * s.dim
            + s.nf * s.Qf * (s.dim - 1))                      # Horner
    mac += tensor_macs(s.D, s.Q1, s.dim)                       # ml
    pointwise += 8 * s.nd + 20 * s.nd                          # LO, ClipScale
    return nbytes, s.E * (2 * mac + pointwise)


def fused_stage_bytes(s, closure=True):
    """Least bytes of one whole stage of the fused main path: kernel 1's,
    the neighbour gather (reads u, writes the trace), the bounds (reads u,
    writes the two class stencils), the RK combine (4 nd) and with the
    closure its per-step reads of the lumped-mass polynomial, u and c and
    write of c spread over the 3 stages."""
    kernel, _ = fused_stage_kernel(s)
    cols = (s.nd + s.nf * s.fd) + (s.nd + 2 * 3 ** s.dim) + 4 * s.nd
    if closure:
        cols += ((s.dim + 1) * s.nd + 3 * s.nd) / 3.0
    return int(kernel + s.itemsize * s.E * cols)


def geometry_convection_kernel(s, with_wdet=False):
    """(bytes, flops) of kernel 4: the moved nodes, the velocity, u and the
    packed 1D tables (the core's, the mesh's, w_q) read once, K u written
    once (and w_q det J `with_wdet`); the Jacobian and the velocity at the
    points, the gradients of u, K u back to the dofs and the cofactor
    algebra at every point."""
    tables = (N_SF_QD * s.Q1 * s.D + s.D * s.D) + 2 * s.Q1 * s.m1 + s.Q
    nbytes = (2 * s.E * s.nm * s.dim + 2 * s.E * s.nd + tables
              + (s.E * s.Q if with_wdet else 0)) * s.itemsize
    mac = (s.dim * gradient_macs(s.m1, s.Q1, s.dim)
           + s.dim * tensor_macs(s.m1, s.Q1, s.dim)
           + gradient_macs(s.D, s.Q1, s.dim) + tensor_macs(s.D, s.Q1, s.dim))
    pointwise = (55 if s.dim == 3 else 14) * s.Q
    if not with_wdet:
        pointwise -= (6 if s.dim == 3 else 4) * s.Q
    return nbytes, s.E * (2 * mac + pointwise)
