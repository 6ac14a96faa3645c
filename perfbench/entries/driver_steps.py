"""Entry of the non-fused product remap: the operator of
`remhos_torch.operator.Advection` stepped as `remhos_torch.driver.run`'s
time loop steps it in float32 with standard RK (driver.py:394-432,
491-533): the Kahan-compensated RK step of `steppers.make_rk_step`, then the
full mass closure of u after every step, its injected mass accumulated on
the device. The program has no function that runs K steps on a built
operator, so these few lines call only the program's own functions.

A phase is `steps` such steps from the initial fields; it ends with the
read-back of the final masses of u and us at the final mesh (the lumped
mass of `Advection.lumped_mass`), as `driver.run` reports them.
"""

from __future__ import annotations

import torch

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
        self.steps, self.dt = traffic["steps_per_remap"], traffic["dt"]
        mesh = make_cartesian_mesh(dim, (n,) * dim, (0.0,) * dim,
                                   (1.0,) * dim, (False,) * dim)
        disc = build_discretization(mesh, config["order"])
        cfg = SolverConfig(problem=solver["problem"], ho=solver["ho"],
                           lo=solver["lo"], fct=solver["fct"],
                           ode_solver=solver["ode_solver"], pa=solver["pa"],
                           product_sync=solver["product_sync"])
        x0 = torch.as_tensor(mesh.x, dtype=F64, device=device)
        v = integrate_mesh_velocity(x0, cfg.problem, mesh.bb_min,
                                    mesh.bb_max, config["mesh_t_final"],
                                    self.dt)
        x0_32, v_32 = x0.to(F32), v.to(F32)
        self.adv = Advection(disc, cfg, x0_32, v_32, dtype=F32,
                             device=device)
        self.step = st.make_rk_step(self.adv.stage_function(), 3,
                                    compensated=True)
        # driver.run's closure: its mass polynomial from the working-dtype
        # nodes, pinned to the float32 initial state in that metric
        mlk, sig = lumped_mass_poly(x0_32, v_32, disc)
        self.mlk32, self.sig = mlk.to(F32), sig.cpu().numpy()
        self.load(S0)

    def load(self, S0):
        """Start the phases from S0 (in float32), the closure pinned to the
        mass of its u."""
        self.S0 = S0.to(F32)
        m0 = float(self.mlk32[0].to(F64).reshape(-1)
                   @ self.S0[0].to(F64).reshape(-1))
        self.closure = st.make_mass_closure(self.mlk32, self.sig, m0)

    def phase(self):
        S, t, dt = self.S0, 0.0, self.dt
        C = torch.zeros_like(S)
        inj = torch.zeros((), dtype=F64, device=S.device)
        for _ in range(self.steps):
            S, C, _ = self.step(S, C, t, dt)
            t += dt
            c_u, deficit = self.closure(S[0], C[0], t)
            inj = inj + deficit.abs()
            C[0] = c_u
        ml = self.adv.lumped_mass(t).to(F64)
        masses = torch.stack([(ml * (S[k].to(F64) + C[k].to(F64))).sum()
                              for k in range(S.shape[0])] + [inj])
        return S, C, masses.tolist()

    @staticmethod
    def state(result):
        """[nfields, E, nd] float64: S + C after the phase."""
        return result[0].double() + result[1].double()

    def counters(self):
        return dict(self.adv.cg_stats)


def build(config, traffic, S0, device):
    return Entry(config, traffic, S0, device)
