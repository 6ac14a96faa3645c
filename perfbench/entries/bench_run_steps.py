"""Entry of the fused main path: `remhos_torch.bench.run_steps` on a
`bench.Case` composed from the program's public set-up calls as
`bench.build_case` composes them, without its float64 verification
operator (nothing in the timed process needs it).

A phase is `run_steps(case, steps)`: `steps` RK3 steps of the fused stage
(kernel 1) with the Kahan combine and the incremental mass closure every
step, then one full closure; it ends with `float(acc)`, the closure's
injected mass read back to the host.
"""

from __future__ import annotations

import torch

from remhos_torch import bench
from remhos_torch import steppers as st
from remhos_torch.discretization import build_discretization
from remhos_torch.driver import integrate_mesh_velocity
from remhos_torch.geometry import lumped_mass_poly
from remhos_torch.mesh import make_cartesian_mesh
from remhos_torch.operator import Advection, SolverConfig

F32, F64 = torch.float32, torch.float64


class Entry:
    def __init__(self, config, traffic, S0, device):
        solver, dim, n = config["solver"], config["dim"], traffic["n"]
        self.steps, dt = traffic["steps_per_remap"], traffic["dt"]
        mesh = make_cartesian_mesh(dim, (n,) * dim, (0.0,) * dim,
                                   (1.0,) * dim, (False,) * dim)
        disc = build_discretization(mesh, config["order"])
        cfg = SolverConfig(problem=solver["problem"], ho=solver["ho"],
                           lo=solver["lo"], fct=solver["fct"],
                           ode_solver=solver["ode_solver"], pa=solver["pa"],
                           poly_bf16=solver.get("poly_bf16", False))
        x0 = torch.as_tensor(mesh.x, dtype=F64, device=device)
        v = integrate_mesh_velocity(x0, cfg.problem, mesh.bb_min,
                                    mesh.bb_max, config["mesh_t_final"], dt)
        mlk, sig = lumped_mass_poly(x0, v, disc)
        self.mlk32, sig = mlk.to(F32), sig.cpu().numpy()
        adv = Advection(disc, cfg, x0.to(F32), v.to(F32), dtype=F32,
                        device=device)
        self.case = bench.Case(
            disc=disc, adv=adv, adv64=None,
            step=st.make_rk_step(adv.stage_function(), 3, compensated=True,
                                 with_delta=True),
            u0=None, u0_64=None, dt=dt, n_steps=self.steps,
            closure_inc=st.make_mass_closure_inc(self.mlk32), sig=sig,
            mlk32=self.mlk32)
        self.adv = adv
        self.load(S0)

    def load(self, S0):
        """Start the phases from S0: u0 in float32 and the closure pinned
        to its mass in the float32 lumped-mass metric (bench.build_case)."""
        u0 = S0[0].to(F32)
        m0 = float(self.mlk32[0].double().reshape(-1)
                   @ u0.double().reshape(-1))
        self.case.u0 = u0
        self.case.closure = st.make_mass_closure(self.mlk32, self.case.sig,
                                                 m0)

    def phase(self):
        return bench.run_steps(self.case, self.steps)

    @staticmethod
    def state(result):
        """[1, E, nd] float64: u + c after the phase."""
        u, c = result[0], result[1]
        return (u.double() + c.double())[None]

    def counters(self):
        return dict(self.adv.cg_stats)


def build(config, traffic, S0, device):
    return Entry(config, traffic, S0, device)
