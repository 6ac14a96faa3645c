"""bench.py's step loop on the JAX side, for holding the port's benchmark
case against it.

`jax_loop` rebuilds bench.make_loop's body from remhos_tpu.steppers and
Advection (the Pallas mega kernel in interpret mode) on a port case's own
inputs (x0, v, u0), with each of bench.py's BENCH_CLOSURE modes: "1" the
incremental closure every step and one full f64 closure at the end, "full"
the full closure every step and no re-anchor, "0" none. In f64 no closure
runs, as in bench.py. bench.py itself is not imported: it sets JAX's global
matmul precision and a compilation cache when imported.
"""

import jax
import jax.numpy as jnp
import numpy as np

from remhos_tpu import geometry as jgeo
from remhos_tpu import steppers as jst
from remhos_tpu.discretization import build_discretization
from remhos_tpu.mesh import make_cartesian_mesh
from remhos_tpu.operator import Advection as JAdvection
from remhos_tpu.operator import SolverConfig as JConfig


def jax_loop(case, n, order, jdt, n_steps, dt, closure="1"):
    """(u, c) in f64 after n_steps steps of bench.make_loop's body for the
    port `case` (an N=n, p=order bench case) in JAX dtype jdt."""
    u, c, _ = jax_run(case, n, order, jdt, n_steps, dt, closure)
    return u, c


def jax_run(case, n, order, jdt, n_steps, dt, closure="1",
            poly_bf16=False):
    """`jax_loop`'s (u, c) and the f64 sum of |mass| the closures absorbed
    (bench.py's `injected`), with `poly_bf16` as bench.py's
    BENCH_POLY_BF16."""
    mesh = make_cartesian_mesh(3, (n,) * 3, (0, 0, 0), (1, 1, 1),
                               (False,) * 3)
    disc = build_discretization(mesh, order)
    x0 = jnp.asarray(case.adv64.x0_nodes.numpy())
    v = jnp.asarray(case.adv64.v_nodes.numpy())
    u0 = jnp.asarray(case.u0_64.numpy())
    cfg = JConfig(problem=10, ho=3, lo=5, fct=2, ode_solver=3, pa=True,
                  use_pallas=True, poly_bf16=poly_bf16)
    full = inc = None
    if jdt == jnp.float32:
        if closure != "0":
            mlk, sig = jgeo.lumped_mass_poly(x0, v, disc)
            mlk32 = mlk.astype(jdt)
            sig = np.asarray(sig)
            m0 = float(mlk32[0].astype(jnp.float64).reshape(-1)
                       @ u0.astype(jdt).astype(jnp.float64).reshape(-1))
            full = jst.make_mass_closure(mlk32, sig, m0)
            if closure == "1":
                inc = jst.make_mass_closure_inc(mlk32, sig)
        x0, v, u0 = x0.astype(jdt), v.astype(jdt), u0.astype(jdt)
    adv = JAdvection(disc, cfg, x0, v, None, dtype=jdt)
    assert adv._mega_stage_eligible()
    step = jax.jit(jst.make_rk_step(adv.stage_function(), 3,
                                    compensated=True,
                                    with_delta=inc is not None),
                   static_argnums=3)
    S, C = jnp.stack([u0]), jnp.zeros((1,) + u0.shape, jdt)
    t = jnp.asarray(0.0, jnp.float64)
    coefs = inc.coefs(dt, n_steps) if inc is not None else None
    injected = 0.0
    for i in range(n_steps):
        t_new = t + dt
        if inc is not None:
            S, C, _, delta = step(S, C, t.astype(jdt), dt)
            c_u, deficit = inc(S[0], C[0], delta[0], t, t_new,
                               coefs=tuple(jnp.asarray(a[i])
                                           for a in coefs))
            C = C.at[0].set(c_u)
            injected += abs(float(deficit))
        else:
            S, C, _ = step(S, C, t.astype(jdt), dt)
            if full is not None:
                c_u, deficit = full(S[0], C[0], t_new)
                C = C.at[0].set(c_u)
                injected += abs(float(deficit))
        t = t_new
    if inc is not None:
        # the exact f64 re-anchor, once a run
        c_u, deficit = full(S[0], C[0], t)
        C = C.at[0].set(c_u)
        injected += abs(float(deficit))
    return (np.asarray(S[0], np.float64), np.asarray(C[0], np.float64),
            injected)
