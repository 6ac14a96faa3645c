"""Explicit time integrators and the conservative mass closures.

The port of `remhos_tpu.steppers`:

- MFEM's standard RK steps (kinds 1-4 and 6, with the reference's stage
  times and update forms), plain or with the Kahan/Neumaier-compensated
  combine. The limiter dt is the full step dt at every stage
  (remhos.cpp:1154);
- IDP (invariant-domain-preserving) RK: every stage re-expressed as a
  limited forward-Euler update through coefficients d from the Butcher
  tableau (RKIDPSolver, remhos_solvers.cpp:40-249; kinds 11, 12, 13, 14,
  16), with the optional stage masks;
- the two f64 mass closures.

The stage function is f(t, dt, u) -> (du, aux). `aux` is the stage's side
channel [dt_ratio, -violations], a small tensor on the device, combined
across stages with an elementwise minimum (the min ratio and the max
violation count); a stage that has nothing to say returns None and is
skipped in the combine, so a step whose stages all return None returns
None and launches nothing for it.

The main path mirrors bench.py, not driver.run: the INCREMENTAL closure
every step and one full f64 closure at the end (bench.py:196-198, 256-263);
driver.run applies the full closure every step (ROADMAP.md Queue 3, "Driver
and bench numerics differ").
"""

from __future__ import annotations

import numpy as np
import torch


def construct_d(a, b, c, s):
    """Convert a Butcher tableau into forward-Euler recombination factors
    (RKIDPSolver::ConstructD, remhos_solvers.cpp:40-95). Host floats, run
    once at setup."""
    a, b, c = list(a), list(b), list(c)
    d = np.zeros(s * (s + 1) // 2)
    a_n_off = 0          # offset into a (or b for the last stage)
    a_o_off = 0
    use_b_n = False
    i_o = -1
    c_o = 0.0
    use_b_o = False

    def coeff(off, use_b, j):
        return b[j] if use_b else a[off + j]

    for i in range(s):
        c_n = c[i] if i < s - 1 else 1.0
        dc = c_n - c_o
        di = i * (i + 1) // 2
        for j in range(i):
            a_oj = coeff(a_o_off, use_b_o, j) if j <= i_o else 0.0
            m = (coeff(a_n_off, use_b_n, j) - a_oj) / dc
            if m == 0.0:
                d[di + j] = 0.0
                continue
            dj = j * (j + 1) // 2
            dij = m / d[dj + j]
            for k in range(j):
                d[di + k] -= d[dj + k] * dij
            d[di + j] = dij
        d[di + i] = coeff(a_n_off, use_b_n, i) / dc

        c_next = c[i + 1] if i < s - 2 else 1.0
        if c_next > c_n:
            i_o = i
            c_o = c_n
            a_o_off, use_b_o = a_n_off, use_b_n
        if i < s - 2:
            a_n_off += i + 1
        else:
            a_n_off, use_b_n = 0, True
    return d


# IDP tableaus (remhos_solvers.cpp:251-279)
IDP_TABLEAUS = {
    12: dict(s=2, a=[.5], b=[0., 1.], c=[.5]),
    13: dict(s=3, a=[1. / 3., 0., 2. / 3.], b=[.25, 0., .75],
             c=[1. / 3., 2. / 3.]),
    14: dict(s=4, a=[1. / 3., -1. / 3., 1., 1., -1., 1.],
             b=[1. / 8., 3. / 8., 3. / 8., 1. / 8.], c=[1. / 3., 2. / 3., 1.]),
    16: dict(s=6,
             a=[.25, 1. / 8., 1. / 8., 0., -.5, 1., 3. / 16., 0., 0., 9. / 16.,
                -3. / 7., 2. / 7., 12. / 7., -12. / 7., 8. / 7.],
             b=[7. / 90., 0., 32. / 90., 12. / 90., 32. / 90., 7. / 90.],
             c=[.25, .25, .5, .75, 1.]),
}


def min_aux(*auxs):
    """Elementwise minimum of the stages' aux tensors; None entries (a
    stage with the constant [inf, 0]) are skipped, all None gives None."""
    out = None
    for a in auxs:
        if a is not None:
            out = a if out is None else torch.minimum(out, a)
    return out


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
    4 classic RK4, 6 Verner's 8-stage RK6); f(t, dt, u) -> (du, aux).

    Plain: step(u, t, dt) -> (u_new, aux). compensated=True: step(u, c, t,
    dt) -> (u_new, c_new, aux), the step's increment formed explicitly and
    Kahan-accumulated into the pair (u, c); the stage states are formed as
    in the plain step, so only the final combine's round-off differs.
    with_delta=True (compensated only) also returns the increment, which
    the incremental mass closure consumes: (u_new, c_new, aux, delta)."""
    if kind == 6:
        return make_tableau_rk_step(f, RK6_BUTCHER, compensated=compensated,
                                    with_delta=with_delta)
    if kind == 1:
        def increment(u, t, dt):
            k1, a1 = f(t, dt, u)
            return dt * k1, a1
    elif kind == 2:
        def increment(u, t, dt):
            k1, a1 = f(t, dt, u)
            k2, a2 = f(t + dt, dt, u + dt * k1)
            return 0.5 * dt * (k1 + k2), min_aux(a1, a2)
    elif kind == 3:
        def increment(u, t, dt):
            k1, a1 = f(t, dt, u)
            y = u + dt * k1
            k2, a2 = f(t + dt, dt, y)
            y = 0.75 * u + 0.25 * (y + dt * k2)
            k3, a3 = f(t + dt / 2, dt, y)
            return (dt / 6.0) * (k1 + k2 + 4.0 * k3), min_aux(a1, a2, a3)

        if not compensated:
            def step(u, t, dt):
                k, a1 = f(t, dt, u)
                y = u + dt * k
                k, a2 = f(t + dt, dt, y)
                y = 0.75 * u + 0.25 * (y + dt * k)
                k, a3 = f(t + dt / 2, dt, y)
                return (u / 3.0 + 2.0 / 3.0 * (y + dt * k),
                        min_aux(a1, a2, a3))
            return step
    elif kind == 4:
        def increment(u, t, dt):
            k1, a1 = f(t, dt, u)
            k2, a2 = f(t + dt / 2, dt, u + dt / 2 * k1)
            k3, a3 = f(t + dt / 2, dt, u + dt / 2 * k2)
            k4, a4 = f(t + dt, dt, u + dt * k3)
            return (dt / 6.0 * (k1 + 2 * k2 + 2 * k3 + k4),
                    min_aux(a1, a2, a3, a4))
    else:
        raise ValueError(f"unsupported RK type {kind}")

    if not compensated:
        def step(u, t, dt):
            delta, aux = increment(u, t, dt)
            return u + delta, aux
        return step

    def cstep(u, c, t, dt):
        delta, aux = increment(u, t, dt)
        u2, c2 = kahan_add(u, c, delta)
        return (u2, c2, aux, delta) if with_delta else (u2, c2, aux)
    return cstep


def make_idp_step(mult_unlimited, limit_mult, kind: int, compute_mask=None,
                  use_masks=False, geometry=None):
    """IDP-RK step(u, t, dt) -> (u_new, aux) mirroring RKIDPSolver::Step
    (remhos_solvers.cpp:171-249).

    mult_unlimited(t, dt, u) -> du_unlimited
    limit_mult(t, dt, u, du) -> (du_limited, aux)
    compute_mask(u) -> bool mask, same shape as u (ComputeMask,
    remhos.cpp:1741-1796); only used when use_masks is True.
    geometry(t) -> the stage cache, made once per distinct stage time and
    threaded through both halves (Advection.geometry). None keeps the plain
    3- and 4-argument calls.

    With use_masks the high-order recombination is applied only on masked
    dofs; unmasked dofs keep the plain stage update (forward Euler), so
    newly activated product-field elements propagate monotonically
    (UpdateMask/AddMasked, remhos_solvers.cpp:97-147, 202-232). The
    reference driver runs UseMask(false) (remhos.cpp:502-506).
    """
    if use_masks and compute_mask is None:
        raise ValueError("use_masks requires a compute_mask function")

    if geometry is None:
        def mu(t, dt, u, cache, key):
            return mult_unlimited(t, dt, u)

        def lm(t, dt, u, du, cache, key):
            return limit_mult(t, dt, u, du)
    else:
        # stage times are t + c*dt with static c, so a per-step cache
        # keyed on c shares one stage cache per distinct stage time
        def _geom(cache, key, t):
            if key not in cache:
                cache[key] = geometry(t)
            return cache[key]

        def mu(t, dt, u, cache, key):
            return mult_unlimited(t, dt, u, geom=_geom(cache, key, t))

        def lm(t, dt, u, du, cache, key):
            return limit_mult(t, dt, u, du, geom=_geom(cache, key, t))

    if kind == 11:
        def step(u, t, dt):
            cache = {}
            du = mu(t, dt, u, cache, 0.0)
            du, aux = lm(t, dt, u, du, cache, 0.0)
            return u + dt * du, aux
        return step

    if kind not in IDP_TABLEAUS:
        raise ValueError(f"unsupported IDP RK type {kind}")
    tab = IDP_TABLEAUS[kind]
    s = tab["s"]
    c = list(tab["c"])
    # Python floats: numpy float64 scalars would promote an f32 state
    d = [float(v) for v in construct_d(tab["a"], tab["b"], tab["c"], s)]

    def step(u, t, dt):
        cache = {}
        dxs = []
        mask = None
        # stage 0
        dt0 = c[0] * dt
        dx = mu(t, dt0, u, cache, 0.0)
        dx, aux = lm(t, dt0, u, dx, cache, 0.0)
        dxs.append(dx)
        c_o = 0.0
        x = u
        t_stage = t
        c_next = c[1] if s > 2 else 1.0
        if c_next > c[0]:
            x = x + dt0 * dx
            t_stage = t + dt0
            c_o = c[0]
            if use_masks:
                mask = compute_mask(x)          # remhos_solvers.cpp:186
        elif use_masks:
            mask = compute_mask(x + dt0 * dx)   # remhos_solvers.cpp:191-195
        for i in range(1, s):
            c_n = c[i] if i < s - 1 else 1.0
            dc = c_n - c_o
            dct = dc * dt
            dx = mu(t_stage, dct, x, cache, c_o)
            if use_masks:
                # UpdateMask: AND with activity of the unlimited HO update
                # (remhos_solvers.cpp:127-147, 213)
                mask = mask & compute_mask(x + dct * dx)
            di = i * (i + 1) // 2
            rec = dx * d[di + i]
            for j in range(i):
                if d[di + j] != 0.0:
                    rec = rec + d[di + j] * dxs[j]
            # AddMasked: unmasked dofs keep dx (forward Euler); masked
            # dofs get the full d-recombination
            # (remhos_solvers.cpp:218-232)
            dx = torch.where(mask, rec, dx) if use_masks else rec
            dx, a = lm(t_stage, dct, x, dx, cache, c_o)
            aux = min_aux(aux, a)
            dxs.append(dx)
            c_next = c[i + 1] if i < s - 2 else 1.0
            if i == s - 1 or c_next > c_n:
                t_stage = t + c_n * dt
                x = x + dct * dx
                c_o = c_n
        return x, aux

    return step


# MFEM's RK6Solver: Verner's "most efficient" 8-stage 6(5) method (mfem
# ode.cpp; selected by -s 6 at remhos.cpp:492), the digits of
# remhos_tpu.steppers.RK6_BUTCHER.
RK6_BUTCHER = dict(
    c=[0.0, .6e-1, .9593333333333333333333333333333333333333e-1, .1439,
       .4973, .9725, .9995, 1.0],
    a=[[],
       [.6e-1],
       [.1923996296296296296296296296296296296296e-1,
        .7669337037037037037037037037037037037037e-1],
       [.35975e-1, 0.0, .107925],
       [1.318683415233148260919747276431735612861, 0.0,
        -5.042058063628562225427761634715637693344,
        4.220674648395413964508014358283902080483],
       [-41.87259166432751461803757780644346812905, 0.0,
        159.4325621631374917700365669070346830453,
        -122.1192135650100309202516203389242140663,
        5.531743066200053768252631238332999150076],
       [-54.43015693531650433250642051294142461271, 0.0,
        207.0672513650184644273657173866509835987,
        -158.6108137845899991828742424365058599469,
        6.991816585950242321992597280791793907096,
        -.1859723106220323397765171799549294623692e-1],
       [-54.66374178728197680241215648050386959351, 0.0,
        207.9528062553893734515824816699834244238,
        -159.2889574744995071508959805871426654216,
        7.018743740796944434698170760964252490817,
        -.1833878590504572306472782005141738268361e-1,
        -.5119484997882099077875432497245168395840e-3]],
    b=[.3438957868357036009278820124728322386520e-1, 0.0, 0.0,
       .2582624555633503404659558098586120858767,
       .4209371189673537150642551514069801967032,
       4.405396469669310170148836816197095664891,
       -176.4831190242986576151740942499002125029,
       172.3641334014150730294022582711902413315],
)


def make_tableau_rk_step(f, tab, compensated: bool = False,
                         with_delta: bool = False):
    """Generic explicit RK from a Butcher tableau; f(t, dt, u) -> (du, aux).
    Same returns as make_rk_step."""
    A, b, c = tab["a"], tab["b"], tab["c"]
    s = len(b)

    def stages(u, t, dt):
        ks, aux = [], None
        for i in range(s):
            ui = u
            for j, aij in enumerate(A[i]):
                if aij != 0.0:
                    ui = ui + dt * aij * ks[j]
            k, a = f(t + c[i] * dt, dt, ui)
            aux = min_aux(aux, a)
            ks.append(k)
        return ks, aux

    def step(u, t, dt):
        ks, aux = stages(u, t, dt)
        out = u
        for i in range(s):
            if b[i] != 0.0:
                out = out + dt * b[i] * ks[i]
        return out, aux

    def cstep(u, comp, t, dt):
        ks, aux = stages(u, t, dt)
        delta = None
        for i in range(s):
            if b[i] != 0.0:
                term = dt * b[i] * ks[i]
                delta = term if delta is None else delta + term
        u2, c2 = kahan_add(u, comp, delta)
        return (u2, c2, aux, delta) if with_delta else (u2, c2, aux)

    return cstep if compensated else step
