"""Entry of the assembled (FA) remap: the operator of
`remhos_torch.operator.Advection` without `-pa`, built in float64 as
`remhos_torch.driver.run` builds it, and stepped by the program's own loop
function, `driver.advance`: standard RK3 with the plain combine and no mass
closure (`driver.run` applies the Kahan combine and the closure only in
float32).

A phase is `steps` such steps from the initial field; it ends with the
read-back of the final mass of u at the final mesh (the lumped mass of
`Advection.lumped_mass`), as `driver.run` reports it.
"""

from __future__ import annotations

import torch

from remhos_torch import steppers as st
from remhos_torch.discretization import build_discretization
from remhos_torch.driver import advance, integrate_mesh_velocity
from remhos_torch.mesh import make_cartesian_mesh
from remhos_torch.operator import Advection, SolverConfig

F64 = torch.float64


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
                           bounds_type=solver["bounds_type"])
        x0 = torch.as_tensor(mesh.x, dtype=F64, device=device)
        v = integrate_mesh_velocity(x0, cfg.problem, mesh.bb_min,
                                    mesh.bb_max, config["mesh_t_final"],
                                    self.dt)
        self.adv = Advection(disc, cfg, x0, v, dtype=F64, device=device)
        self.step = st.make_rk_step(self.adv.stage_function(),
                                    cfg.ode_solver)
        self.load(S0)

    def load(self, S0):
        """Start the phases from S0."""
        self.S0 = S0.to(F64)

    def phase(self):
        S, _, t, _, _ = advance(self.step, self.S0, 0.0, self.dt, self.steps)
        return S, float((self.adv.lumped_mass(t) * S[0]).sum())

    @staticmethod
    def state(result):
        """[1, E, nd] float64: u after the phase."""
        return result[0]

    def counters(self):
        return {}


def build(config, traffic, S0, device):
    return Entry(config, traffic, S0, device)
