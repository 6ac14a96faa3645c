"""Entry of transport with Remhos's monolithic RD solver and the smoothness
indicator (`-p 7 -o 1 -mono 1 -si 2`): the operator of
`remhos_torch.driver.build_operator` for `-m inline-quad -rs <k>` (n = 4
2^k elements an axis), assembled once in float64 with problem 7's inflow,
and stepped by the program's own loop function, `driver.advance`: standard
RK3 with the plain combine and no mass closure (transport with an inflow
conserves no mass).

A phase is `steps` such steps from the initial field; it ends with the
read-back of the mass of u in the lumped mass, as `driver.run` reports it.
"""

from __future__ import annotations

import math

import torch

from remhos_torch import steppers as st
from remhos_torch.config import RunConfig
from remhos_torch.driver import advance, build_operator
from remhos_torch.si import SmoothnessIndicator

F64 = torch.float64


def run_config(config, traffic, device):
    """The RunConfig of the cell: `-m inline-quad` refined to traffic's n."""
    solver, n = config["solver"], traffic["n"]
    rs = round(math.log2(n / 4)) if n >= 4 else -1
    if rs < 0 or 4 * 2 ** rs != n:
        raise ValueError(f"inline-quad refines 4 x 4 quads: n = 4 2^k, "
                         f"not {n}")
    return RunConfig(mesh=config["mesh"], problem=solver["problem"],
                     rs_levels=rs, order=config["order"],
                     mesh_order=config["mesh_order"], dt=traffic["dt"],
                     ho=solver["ho"], lo=solver["lo"], fct=solver["fct"],
                     mono=solver["mono"], smth_ind=solver["smth_ind"],
                     pa=solver["pa"], ode_solver=solver["ode_solver"],
                     bounds_type=solver["bounds_type"],
                     dtype=config["dtype"], device=device, verbose=False)


class Entry:
    def __init__(self, config, traffic, S0, device):
        if not hasattr(SmoothnessIndicator, "evaluations"):
            # a program without the counters this entry reports: refuse
            # here, before the set-up (minutes at 2048^2 where the
            # indicator's tables are built element by element); an
            # untraced run never reads the counters, so it would refuse
            # no sooner than its end
            raise RuntimeError("remhos_torch's smoothness indicator counts "
                               "no evaluations: this entry needs a program "
                               "that does")
        self.steps, self.dt = traffic["steps_per_remap"], traffic["dt"]
        cfg = run_config(config, traffic, device)
        self.adv, _ = build_operator(cfg)
        self.step = st.make_rk_step(self.adv.stage_function(),
                                    cfg.ode_solver)
        self.load(S0)

    def load(self, S0):
        """Start the phases from S0."""
        self.S0 = S0.to(device=self.adv.device, dtype=F64)

    def phase(self):
        S, _, t, _, _ = advance(self.step, self.S0, 0.0, self.dt, self.steps)
        return S, float((self.adv.lumped_mass(t) * S[0]).sum())

    @staticmethod
    def state(result):
        """[1, E, nd] float64: u after the phase."""
        return result[0]

    def counters(self):
        """The explicit passes of the monolithic solver and the indicator's
        evaluations."""
        return {"mono_explicit": self.adv.mono_stats["explicit"],
                "si_evaluations": self.adv.smth.evaluations}


def build(config, traffic, S0, device):
    return Entry(config, traffic, S0, device)
