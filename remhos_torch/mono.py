"""Monolithic residual-distribution solver (`-mono 1|2`): the port of
`remhos_tpu.mono` (MonoRDSolver, remhos_mono.cpp:25-356).

One nonlinear pass gives the limited solution directly: per-dof limiter
alphas, nonlinear (conservation-rescaled) flux lumping, optional subcell
fluctuations (`-mono 2`), an optional smoothness indicator that relaxes the
limiters in smooth regions (`-si`), and an inner fixed-point iteration that
restores the consistent-mass accuracy (eqs. 27-29). It reads the assembled
M, K_elem, bdrInt and ml, so it runs on the assembled stage only, as in the
reference.

On the card `-mono 1`'s explicit part past the bounds and the indicator
(K u, the limiters, the alpha-weighted flux lumping, the RD weights) is one
launch of `ops/mono_rd` (`mono_rd.engages` decides); `-mono 2`, other
element sizes and the CPU run its plain chain, `mono_rd_reference`.

Spans (`utils/trace.py`, only under a profiler): `remhos.mono` around a
solution (the explicit part, kernel or plain chain, in its self time), and
inside it `remhos.bounds` (the element extrema and the dof bounds),
`remhos.si` (the indicator and its dof values), `remhos.lumping` (the
neighbour gather) and `remhos.mono_loop` (the inner loop).
`adv.mono_stats["explicit"]` counts the explicit passes; the indicator
counts its own evaluations.

The reference's inner loop walks each element on its own
(remhos_mono.cpp:285-291). Here, as in the JAX package, one masked loop runs
over all elements at once and an element freezes when its residual drops to
TOL; a frozen element never changes again. The loop's exit test is a read
back from the device, so it is made every `CHECK_EVERY` iterations, never
past the JAX package's cap of 101 iterations: the iterations past the last
element's freeze change nothing, so the result is the JAX package's
whatever the interval.
"""

from __future__ import annotations

import numpy as np
import torch

from . import assembly as asm
from . import basis as B
from . import bounds as bnd
from . import problems as prob
from .mono_lumping import BETA, EPS, _rescale
from .ops import mono_rd as mrm
from .utils.trace import host_wait, span, spanned

TOL = 1.0e-8
# the JAX package's while_loop runs while it <= 100: at most 101 iterations
MAX_ITER = 101
# iterations between two exit tests of the inner loop (one read back each)
CHECK_EVERY = 8


def velocity_scale(mesh, disc, problem):
    """scale[E] = vmax / (2 sqrt(dim) h / p) (remhos_mono.cpp:39-57), vmax
    sampled at the reference's quadrature (qOrdE = OrderW + 2p +
    2*OrderGrad, remhos_mono.cpp:46) on the initial mesh. Setup, numpy (the
    velocity evaluated in f64)."""
    dim, p, mo = mesh.dim, disc.p, mesh.mesh_order
    orderW = mo * dim - 1
    orderGrad = mo * (dim - 1) + p - 1
    q_ord = orderW + 2 * p + 2 * max(orderGrad, 0)
    q1, _ = B.gauss_legendre(B.min_gauss_points(q_ord))
    Bm = B.tensor_mixed([B.lagrange_vals(B.gauss_lobatto(mo + 1), q1)] * dim)
    x_q = np.einsum("qn,end->eqd", Bm, mesh.x)
    v = prob.velocity_function(problem, torch.as_tensor(x_q), mesh.bb_min,
                               mesh.bb_max).numpy()
    vmax = np.sqrt((v * v).sum(-1)).max(axis=1)
    return vmax / (2.0 * (np.sqrt(dim) * mesh.element_sizes() / p))


@spanned("remhos.mono")
def mono_rd_solution(adv, geom, u, dt):
    """MonoRDSolver::CalcSolution (remhos_mono.cpp:60-356), batched over
    the elements. `adv.mono_stats` counts the explicit passes, the inner
    loops, their iterations and their read-backs."""
    final = adv.cfg.problem in (6, 7)      # no mass limiting, remhos.cpp:999
    du, d_full, xi_min, xi_max, si_dof = explicit_part(adv, geom, u, final)
    if final:
        return du
    m_it = consistent_mass_loop(adv, geom, u, du, d_full, xi_min, xi_max,
                                si_dof)
    return (du + m_it) / geom["ml"]


def explicit_part(adv, geom, u, final=False):
    """Everything of the solution but the inner loop (remhos_mono.cpp:
    60-260): (du, d_full, xi_min, xi_max, si_dof), du the limited
    fluctuations with the face terms and the RD weighting, d_full the
    unlimited ones, the dof bounds and the indicator at the dofs (None
    without -si). With `final` (no inner loop follows) du is the rate (du
    + 0) / ml and d_full None. One launch of `ops/mono_rd` where it engages
    (`-mono 1` on the card), else its plain chain."""
    cfg = adv.cfg
    adv.mono_stats["explicit"] += 1

    with span("remhos.bounds"):
        el_min, el_max = bnd.elements_min_max(u)
        xi_min, xi_max = adv.compute_bounds(el_min, el_max)

    si_dof = None
    if cfg.smth_ind:
        with span("remhos.si"):
            si_dof = adv.smth.dof_values(adv.smth.compute(u))

    with span("remhos.lumping"):
        u_nbr = adv.gather_nbr(u, adv.inflow_face)
    if mrm.engages(u.device, u.dtype, adv.disc.dim, u.shape[1], cfg.mono):
        xi_min, xi_max = xi_min.contiguous(), xi_max.contiguous()
        if si_dof is not None:
            si_dof = si_dof.contiguous()
        du, d_full = mrm.mono_rd(geom, u, xi_min, xi_max, si_dof, u_nbr,
                                 adv.mono_rd_tables, final)
    else:
        du, d_full = mrm.mono_rd_reference(
            geom, u, xi_min, xi_max, si_dof, u_nbr, adv.bdr_dofs, final,
            adv._sub2ind if cfg.mono == 2 else None)
    return du, d_full, xi_min, xi_max, si_dof


def bound_preserving_dt(adv, geom):
    """[E, nd]: a step under which `explicit_part`'s forward-Euler update,
    and so each SSP RK stage, keeps every dof within its bounds: ml_i / c_i
    (a sufficient condition, `-mono 1`). Each part of the update moves u_i
    toward its bound by at most its coefficient times u_i's distance to it:

    - the limited K u: alpha_i |z_i| <= BETA sum_j!=i |K_ij| (u_i - bound),
      the u_j of the element lying within u_i's bounds;
    - a face's lumped term: row_i, its own neighbour value within the
      bounds; its correction: 3 BETA sum_j!=i |B_ij|, the face's and the
      neighbour's values within them;
    - the residual distribution: sum_k sum_j!=k |K_kj| over the element,
      the share of u_i of the element's remainder at most (u_i - x_min) /
      (x_max - x_min).

    On an inflow face the neighbour values are the inflow's, which u_i's
    bounds need not hold: there the correction's bound holds as far as
    the inflow varies across the face less than u does."""
    K, B, ml = geom["K_elem"], geom["bdrInt"], geom["ml"]
    offK = K.abs().sum(2) - K.diagonal(dim1=1, dim2=2).abs()
    row = B.sum(3)
    offB = B.abs().sum(3) - B.diagonal(dim1=2, dim2=3).abs()
    face = asm.scatter_face_add(torch.zeros_like(ml), row + 3.0 * BETA * offB,
                                adv.bdr_dofs)
    return ml / (BETA * offK + face + offK.sum(1, keepdim=True))


@spanned("remhos.mono_loop")
def consistent_mass_loop(adv, geom, u, du, d_full, xi_min, xi_max, si_dof):
    """The inner consistent-mass iteration (remhos_mono.cpp:262-348) over
    all elements at once, on `explicit_part`'s output; returns m_it[E,
    nd]."""
    M, ml = geom["M"], geom["ml"]
    scale = adv.mono_scale[:, None]
    Msum = M.sum(dim=2)
    diff = d_full - du
    t = si_dof if si_dof is not None else torch.zeros_like(u)
    up = torch.minimum(xi_max - u, u - xi_min)
    upG = torch.minimum(1.0 - u, u) if si_dof is not None else None

    def body(m_it, done):
        uDot = (du + m_it) / ml
        uDotMin = uDot.amin(dim=1, keepdim=True)
        uDotMax = uDot.amax(dim=1, keepdim=True)
        # sum_j M_ij (uDot_i - uDot_j)
        m_new = asm.matvec(M, -uDot) + Msum * uDot
        m_new = m_new + torch.clamp(torch.maximum(
            t, m_new.abs() / (diff.abs() + EPS)), max=1.0) * diff
        spread = torch.maximum(uDotMax - uDot, uDot - uDotMin) + EPS
        a = torch.clamp(BETA * scale * up / spread, max=1.0)
        if si_dof is not None:
            aG = torch.clamp(BETA * scale * upG / spread, max=1.0)
            a = torch.minimum(torch.maximum(si_dof, a), aG)
        m_new = m_new * a
        m_new = _rescale(m_new, m_new.clamp(min=0.0).sum(1, keepdim=True),
                         m_new.clamp(max=0.0).sum(1, keepdim=True))
        m_it = torch.where(done[:, None], m_it, m_new)
        res = m_new + du - ml * uDot
        done = done | (torch.sqrt((res * res).sum(1)) <= TOL)
        return m_it, done

    k = CHECK_EVERY
    m_it = torch.zeros_like(u)
    done = torch.zeros(u.shape[0], dtype=torch.bool, device=u.device)
    it = reads = 0
    while it < MAX_ITER:
        for _ in range(min(k, MAX_ITER - it)):
            m_it, done = body(m_it, done)
            it += 1
        reads += 1
        if not host_wait(bool, (~done).any()):
            break
    st = adv.mono_stats
    st["solves"] += 1
    st["iterations"] += it
    st["max_iterations"] = max(st["max_iterations"], it)
    st["readbacks"] += reads
    return m_it
