"""Dof-level runtime bounds verification (-vb).

The port of `remhos_tpu.verify`. With -vb every RK stage checks every dof
against its admissible interval (check_violation, remhos.cpp:1557-1594, call
sites :1824-1837), the FCT product solver verifies s_avg and the final us
against the scaled bounds (remhos_fct.cpp:84-101, 568-610), and
VerifyLOProduct checks the compatible-LO product theorem
(remhos_sync.cpp:180-228).

The reference aborts at the first violating dof. Here each check returns a
violation COUNT, an int32 tensor on the device of its inputs; the counts are
accumulated into the step's aux channel (operator.limit_mult) and the driver
raises as soon as a step reports a nonzero count: one fetch per step.

TOL is the reference's f64 tolerance. A float32 ClipScale result misses it
by round-off, so -vb is a float64 instrument.
"""

from __future__ import annotations

import torch

TOL = 1e-12  # the reference's check tolerance (remhos.cpp:1826, 1835)
INF = float("inf")


def _count(bad):
    return bad.sum(dtype=torch.int32)


def count_out_of_bounds(u_new, u_min, u_max, tol=TOL, active=None):
    """Number of dofs with u_new outside [u_min - tol, u_max + tol]
    (check_violation, remhos.cpp:1557-1575)."""
    bad = (u_new + tol < u_min) | (u_new > u_max + tol)
    if active is not None:
        bad = bad & active
    return _count(bad)


def check_violation(u, dt, du, u_min, u_max, tol=TOL, active=None):
    """check_violation on a forward-Euler update u + dt*du
    (remhos.cpp:1577-1594)."""
    return count_out_of_bounds(u + dt * du, u_min, u_max, tol, active)


def check_s_avg(mass_us, mass_u, s_avg, smin, smax, active_el, eps=TOL):
    """Per-element s_avg stencil-bounds check inside
    CalcCompatibleLOProduct (remhos_fct.cpp:84-101): s_avg = mass_us/mass_u
    must lie in the full active-dof stencil bounds [smin, smax] after the
    round-off fixes. Inputs are per-element [E]; returns a count. (A NaN
    from inf * 0 on an element without active dofs compares false.)"""
    bad = ((mass_us + eps < smin * mass_u) |
           (mass_us - eps > smax * mass_u) |
           (s_avg + eps < smin) |
           (s_avg - eps > smax))
    return _count(bad & active_el)


def check_final_us(us, dt, d_us, us_min, us_max, active_el, active_dofs,
                   eps=TOL):
    """Final product-solution bounds check after CalcFCTProduct
    (ClipScale remhos_fct.cpp:568-610): us + dt*d_us within
    [us_min - eps, us_max + eps] on active dofs of active elements."""
    us_new = us + dt * d_us
    bad = (us_new + eps < us_min) | (us_new - eps > us_max)
    return _count(bad & active_el[:, None] & active_dofs)


def verify_lo_product(us_LO, u_LO, s_min, s_max, active_el, active_dofs,
                      eps=TOL):
    """Basic LO product theorem (VerifyLOProduct, remhos_sync.cpp:180-228):
    on every active dof of an active element, us_LO must lie in
    [smin_K * u_LO, smax_K * u_LO] where smin_K/smax_K are the element-wide
    extrema of the dof bounds over active dofs. Returns a count. (A debug
    helper in the reference; its driver never calls it.)"""
    smin_el = torch.where(active_dofs, s_min, INF).amin(dim=1)
    smax_el = torch.where(active_dofs, s_max, -INF).amax(dim=1)
    lo = smin_el[:, None] * u_LO
    hi = smax_el[:, None] * u_LO
    bad = (us_LO + eps < lo) | (us_LO - eps > hi)
    return _count(bad & active_el[:, None] & active_dofs)
