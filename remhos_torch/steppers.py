"""Explicit RK time stepping and the conservative mass closures.

The port of the `remhos_tpu.steppers` subset on the main path: MFEM's
standard RK steps (kinds 1-4, with the reference's stage times and update
forms), the Kahan/Neumaier-compensated combine, and the two f64 mass
closures. The stage function is f(t, dt, u) -> du; the limiter dt is the
full step dt at every stage (remhos.cpp:1154).

The main path mirrors bench.py, not driver.run: the INCREMENTAL closure
every step and one full f64 closure at the end (bench.py:196-198, 256-263);
driver.run applies the full closure every step (ROADMAP.md Queue 3, "Driver
and bench numerics differ").
"""

from __future__ import annotations

import numpy as np
import torch


def kahan_add(u, c, delta):
    """Neumaier-compensated accumulation: (u + c) + delta carried as a
    hi/lo pair. Removes the ~0.6-ulp/step rounding bias of a plain f32
    combine. Returns (u_new, c_new)."""
    y = delta + c
    t = u + y
    c_new = torch.where(u.abs() >= y.abs(), (u - t) + y, (y - t) + u)
    return t, c_new


def make_mass_closure(mlk, sig, m_target):
    """Full conservative mass closure in f64.

    The state is the Kahan pair (u, c) with u_exact = u + c; the mass
    functional M(t) = <ml(t), u + c>, ml(t) = sum_k t^k mlk[k], is measured
    in f64 and its deficit against m_target is injected as a uniform shift
    of c. Returns close(u, c, t) -> (c_new, deficit), deficit a 0-dim f64
    tensor (the mass injected by this call), which the caller must budget.

    mlk: [K, E, nd] (stored f32 on the main path); sig: [K] f64 totals;
    m_target: float."""
    K = int(mlk.shape[0])
    mlk2 = mlk.reshape(K, -1)
    sig64 = torch.as_tensor(np.asarray(sig, np.float64), device=mlk.device)

    def close(u, c, t):
        s = (u.double() + c.double()).reshape(-1)
        dots = mlk2.double() @ s                                 # [K]
        tk = torch.tensor([float(t) ** k for k in range(K)],
                          dtype=torch.float64, device=mlk.device)
        deficit = m_target - dots @ tk
        S = sig64 @ tk
        return c + (deficit / S).to(c.dtype), deficit

    return close


def closure_coefs(sig, dt, n_steps):
    """Host-precomputed per-step f64 scalars for the incremental closure:
    (tk0 [n, K], dtk [n, K], S [n]) with tk0 = t0^k, dtk = t1^k - t0^k and
    S = <sig, t1^k> at t0 = i*dt, t1 = (i+1)*dt."""
    sig = np.asarray(sig, np.float64)
    K = sig.shape[0]
    i = np.arange(n_steps, dtype=np.float64)
    tk0 = (i * dt)[:, None] ** np.arange(K)
    tk1 = ((i + 1.0) * dt)[:, None] ** np.arange(K)
    return tk0, tk1 - tk0, tk1 @ sig


CLOSURE_BLOCK = 1024    # f32 partial-sum length of the incremental closure


def make_mass_closure_inc(mlk):
    """Incremental conservative mass closure: per-step work in f32.

    The previous step left the state closed, so the new deficit is minus the
    mass increment, with s1 = u + c after the step and d its increment:
        M(t1, s1) - M(t0, s1 - d)
            = sum_k t0^k <mlk, d> + sum_{k>=1} (t1^k - t0^k) <mlk, s1>.
    Both terms carry O(dt) magnitudes, so f32 products are enough. The dots
    are f32 partial sums over blocks of CLOSURE_BLOCK entries with an f64
    sum over the blocks, as in bench.py's version. The residual tracking
    error is re-anchored by one full closure (make_mass_closure) at the end
    of a run.

    Returns close(u_new, c_new, delta, coefs) -> (c_out, deficit); coefs =
    (tk0, dtk, S) for this step, row i of closure_coefs as f64 tensors."""
    K = int(mlk.shape[0])
    N = int(np.prod(mlk.shape[1:]))
    nb = -(-N // CLOSURE_BLOCK)
    pad = nb * CLOSURE_BLOCK - N
    mlkb = torch.nn.functional.pad(mlk.reshape(K, -1), (0, pad)).reshape(
        K, nb, CLOSURE_BLOCK)

    def _dots(u, c, delta):
        s1 = (u + c).reshape(-1)
        X = torch.stack([delta.reshape(-1), s1])                 # [2, N]
        X = torch.nn.functional.pad(X, (0, pad)).reshape(2, nb,
                                                         CLOSURE_BLOCK)
        parts = (mlkb[:, None] * X[None]).sum(-1)                # [K, 2, nb]
        return parts.double().sum(-1)                            # [K, 2]

    def close(u, c, delta, coefs):
        dots = _dots(u, c, delta)
        tk0, dtk, S = coefs
        deficit = -(tk0 * dots[:, 0] + dtk * dots[:, 1]).sum()
        return c + (deficit / S).to(c.dtype), deficit

    return close


def make_rk_step(f, kind: int, compensated: bool = False,
                 with_delta: bool = False):
    """Standard RK step (MFEM: 1 forward Euler, 2 RK2(1), 3 RK3-SSP,
    4 classic RK4).

    Plain: step(u, t, dt) -> u_new. compensated=True: step(u, c, t, dt) ->
    (u_new, c_new), the step's increment formed explicitly and
    Kahan-accumulated into the pair (u, c); the stage states are formed as
    in the plain step, so only the final combine's round-off differs.
    with_delta=True (compensated only) also returns the increment, which
    the incremental mass closure consumes: (u_new, c_new, delta)."""
    if kind == 1:
        def increment(u, t, dt):
            return dt * f(t, dt, u)
    elif kind == 2:
        def increment(u, t, dt):
            k1 = f(t, dt, u)
            k2 = f(t + dt, dt, u + dt * k1)
            return 0.5 * dt * (k1 + k2)
    elif kind == 3:
        def increment(u, t, dt):
            k1 = f(t, dt, u)
            y = u + dt * k1
            k2 = f(t + dt, dt, y)
            y = 0.75 * u + 0.25 * (y + dt * k2)
            k3 = f(t + dt / 2, dt, y)
            return (dt / 6.0) * (k1 + k2 + 4.0 * k3)

        if not compensated:
            def step(u, t, dt):
                k = f(t, dt, u)
                y = u + dt * k
                k = f(t + dt, dt, y)
                y = 0.75 * u + 0.25 * (y + dt * k)
                k = f(t + dt / 2, dt, y)
                return u / 3.0 + 2.0 / 3.0 * (y + dt * k)
            return step
    elif kind == 4:
        def increment(u, t, dt):
            k1 = f(t, dt, u)
            k2 = f(t + dt / 2, dt, u + dt / 2 * k1)
            k3 = f(t + dt / 2, dt, u + dt / 2 * k2)
            k4 = f(t + dt, dt, u + dt * k3)
            return dt / 6.0 * (k1 + 2 * k2 + 2 * k3 + k4)
    else:
        raise NotImplementedError(
            f"RK kind {kind}: the tableau and IDP steppers are not ported "
            "yet (ROADMAP.md Queue 1, item 9)")

    if not compensated:
        def step(u, t, dt):
            return u + increment(u, t, dt)
        return step

    def cstep(u, c, t, dt):
        delta = increment(u, t, dt)
        u2, c2 = kahan_add(u, c, delta)
        return (u2, c2, delta) if with_delta else (u2, c2)
    return cstep
