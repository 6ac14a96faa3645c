"""The least work of one stage of transport with Remhos's monolithic RD
solver and the smoothness indicator, `-mono 1 -si 2 -bt 0` on one field
(problem 7: no consistent-mass inner loop), from the cell's sizes: the
yardstick of `mono_stage_roofline`. The count is the same whatever does
the work.

Bytes count the stage's inputs read once and its output written once: the
nodes x0 [E, nm, dim], u [E, nd] in, du [E, nd] out, and the inflow values
at the dofs of the boundary faces. The element matrices (M, K, the upwind
face blocks) and the indicator's tables are the stage's own intermediates:
a stage that formed them in fast memory would move none of them.

Operations count 2 per multiply-add and 1 per other operation, per
element (the indicator's vertex grid has as many vertices as elements, to
one row and column). Work is sum-factorized where the tensor structure
allows (the geometry and the quadrature sums of the element matrices) and
dense on the element's nd dofs elsewhere. The result reads one nonlinear
flux lumping, with the limiters: the second (alpha = 1) feeds only the
inner loop, which problem 7 does not run.
"""

from __future__ import annotations

from perfbench.yardstick import gradient_macs, least_seconds, tensor_macs
from perfbench.yardstick_fa import matrix_macs

# pointwise operations at a volume point in 2D: the adjugate (2), det J
# (3), w det J (1), the velocity (y, -x) (1), adj J v (4 multiply-adds) and
# its weight (2)
VOLUME_POINT_OPS = 17
# at a face point in 2D: the normal from the tangent (1), the velocity (1),
# v.n (1 multiply-add and a product), w max(0, -v.n) (3)
FACE_POINT_OPS = 8
# the -si 2 formula at a vertex: two products, max(0, .), two squares, a
# max, + eps, a division, x 3 and min(1, .)
SI_FORMULA_OPS = 10
# the limiter of a dof (remhos_mono.cpp:128-154): the distances to the
# bounds and their alpha (8), the indicator's relaxed bounds and their two
# alphas (26), the three-way choice (6), alpha z and (1 - alpha) z (3)
LIMITER_OPS = 43
# one face dof of NonlinFluxLumping beyond B (u_nbr - u): the difference,
# the row sum's share, the lumped term, the correction and its alpha (5),
# the signed sums (4) and the rescaling (6), the scatter (1)
LUMPING_OPS = 16


def mono_stage_parts(s):
    """{part: operations per element} of one stage on `s` (a
    `yardstick.Sizes`, dim 2, p = 1: one subcell an element):

    - geometry: J (dim gradients of the dim node components) and x at the
      volume points, VOLUME_POINT_OPS a point;
    - faces: at each face's points the tangent and x, FACE_POINT_OPS a
      point;
    - matrices: M, K (dim weights, each with one derivative factor), each
      face's upwind block on the face rule, and ml as a tensor contraction;
    - bounds: the element extrema and the vertex stencil (3^dim - 1
      comparisons for each of min and max);
    - si: the Q1 mass of the values summed to the vertices, two Neumann
      inversions (y1 = b / l, the residual M y1 - b, its norm and the
      update), the Q1 Laplacian, the 3^dim extrema, the formula and the
      values at the dofs;
    - mono: K u and each dof's limiter;
    - lumping: one NonlinFluxLumping a face (B (u_nbr - u) and
      LUMPING_OPS a face dof);
    - rd: the residual distribution of the rest (the extrema, the signed
      sums, the two weights, the update: 15 a dof and 6 an element);
    - combine: the division by ml and the RK3 combines, a third of a
      step's 12 a dof."""
    dim, d, q = s.dim, s.D, s.Q1
    nd, fd, nf, m1 = s.nd, s.fd, s.nf, s.m1
    stencil = 2 * (3 ** dim - 1)
    mass = 2 * nd * nd + nd                 # a block product to vertices
    neumann = 1 + mass + 1 + 2 + 2
    return dict(
        geometry=2 * dim * (gradient_macs(m1, q, dim)
                            + tensor_macs(m1, q, dim))
        + VOLUME_POINT_OPS * s.Q,
        faces=nf * (2 * dim * (gradient_macs(m1, q, dim - 1)
                               + tensor_macs(m1, q, dim - 1))
                    + FACE_POINT_OPS * s.Qf),
        matrices=2 * ((1 + dim) * matrix_macs(d, q, dim)
                      + nf * matrix_macs(d, q, dim - 1)
                      + tensor_macs(d, q, dim)),
        bounds=2 * nd + stencil,
        si=mass + 2 * neumann + mass + stencil + SI_FORMULA_OPS + nd,
        mono=2 * nd * nd + LIMITER_OPS * nd,
        lumping=nf * (2 * fd * fd + LUMPING_OPS * fd),
        rd=15 * nd + 6,
        combine=nd + 4 * nd,
    )


def mono_stage(s):
    """(bytes, operations) of one stage on the whole mesh."""
    inflow = s.nf * s.n ** (s.dim - 1) * s.fd
    nbytes = (s.E * (s.nm * s.dim + 2 * s.nd) + inflow) * s.itemsize
    return nbytes, s.E * sum(mono_stage_parts(s).values())


def least_stage_seconds(s):
    """The least time of one stage: the larger of its bytes over the peak
    memory rate and its operations over the peak rate."""
    return least_seconds(*mono_stage(s))
