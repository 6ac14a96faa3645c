"""The least work of one assembled (FA) remap stage, `-ho 3 -lo 1 -fct 1
-bt 0` on one field, from the cell's sizes: the yardstick of
`fa_stage_roofline`. The count is the same whatever does the work.

Bytes count the stage's inputs read once and its output written once: the
nodes x0 and the mesh velocity v [E, nm, dim], u [E, nd] in, du [E, nd]
out. The element matrices are the stage's own intermediates: a stage that
kept them in fast memory would move none of them.

Operations count 2 per multiply-add and 1 per other operation, per
element. Work is sum-factorized where the tensor structure allows (the
geometry and the quadrature sums that form the element matrices: one
rule axis at a time) and dense where the algorithm needs element matrices
(the Cholesky factorization, the solves, the matrix-vector products, the
discrete upwinding and the antidiffusive fluxes, nd^2 pairs each).
"""

from __future__ import annotations

from perfbench.yardstick import gradient_macs, least_seconds, tensor_macs


def matrix_macs(d, q, dim):
    """Multiply-adds of one element matrix sum_q W(q) prod_a T_a(q_a, i_a,
    j_a) on a tensor rule of q^dim points with d^dim dofs, contracted one
    axis at a time: q^dim d^2 + q^(dim-1) d^4 + ... + q d^(2 dim)."""
    return sum(q ** (dim - k + 1) * d ** (2 * k) for k in range(1, dim + 1))


def fa_stage_parts(s):
    """{part: operations per element} of one stage on `s` (a
    `yardstick.Sizes`):

    - geometry: J (dim gradients of the dim node components) and v at the
      volume points, and 55 operations a point: the cofactors, det J and
      w adj(J) v;
    - faces: at each face's points the two tangents and v, and 17
      operations a point: the normal n, v.n and w max(0, v.n);
    - matrices: M, K (dim weights, each with one derivative factor), each
      face's upwind block on the face rule, and ml as a tensor contraction;
    - factor: the Cholesky factorization of M, nd^3 / 3;
    - ho: K u, the face coupling (own and neighbour trace) and the two
      triangular solves;
    - lo: D = K + d (d_ij = max(0, -k_ij, -k_ji) and its row sums), D u,
      the row-lumped face fluxes, the division by ml;
    - bounds: the element extrema and the overlap stencil's class pass
      (3^dim - 1 comparisons for each of min and max);
    - flux: K_HO's own-own face terms, d_ij, and f_ij = dt d_ij (u_i - u_j)
      + dt M_ij (du_i - du_j);
    - sweep: one Zalesak sweep, the flux sums, the factors and the limited
      update (9 a pair, 15 a dof);
    - combine: the RK3 combines, a third of a step's 12 a dof."""
    dim, d, q = s.dim, s.D, s.Q1
    nd, fd, nf, m1 = s.nd, s.fd, s.nf, s.m1
    return dict(
        geometry=2 * dim * (gradient_macs(m1, q, dim)
                            + tensor_macs(m1, q, dim)) + 55 * s.Q,
        faces=nf * (2 * dim * (gradient_macs(m1, q, dim - 1)
                               + tensor_macs(m1, q, dim - 1)) + 17 * s.Qf),
        matrices=2 * ((1 + dim) * matrix_macs(d, q, dim)
                      + nf * matrix_macs(d, q, dim - 1)
                      + tensor_macs(d, q, dim)),
        factor=nd ** 3 / 3,
        ho=2 * nd * nd + nf * (2 * fd * fd + fd) + 2 * nd * nd,
        lo=6 * nd * nd + 2 * nd * nd + nf * (fd * fd + 2 * fd) + nd,
        bounds=2 * nd + 2 * (3 ** dim - 1),
        flux=nf * fd * fd + 3 * nd * nd + 7 * nd * nd,
        sweep=9 * nd * nd + 15 * nd,
        combine=4 * nd,
    )


def fa_stage(s):
    """(bytes, operations) of one stage on the whole mesh."""
    nbytes = s.E * (2 * s.nm * s.dim + 2 * s.nd) * s.itemsize
    return nbytes, s.E * sum(fa_stage_parts(s).values())


def least_stage_seconds(s):
    """The least time of one stage: the larger of its bytes over the peak
    memory rate and its operations over the peak rate."""
    return least_seconds(*fa_stage(s))
