"""Setup helpers of the remap driver (the `remhos_tpu.driver` subset the
main path uses): the Bernstein projection of the initial condition and the
integrated remap pseudo-velocity."""

from __future__ import annotations

import torch

from . import problems as prob


def _project_bernstein(x_nodes, Bm_at_unodes, func):
    """MFEM PositiveFiniteElement::Project: function values at the
    closed-uniform nodes become the Bernstein dofs (remhos.cpp:883).
    Returns (dofs[E, nd], x_unodes[E, nd, dim])."""
    B = torch.as_tensor(Bm_at_unodes, dtype=x_nodes.dtype,
                        device=x_nodes.device)
    x_unodes = torch.einsum("end,mn->emd", x_nodes, B)
    return func(x_unodes), x_unodes


def _integrate_mesh_velocity(x0, problem, bb_min, bb_max, t_final, dt):
    """Remap pseudo-velocity v = x_final - x0: the mesh nodes integrated to
    t_final with the analytic velocity by forward Euler (remhos.cpp:560-584).

    The step list is computed on the host with the reference's own float
    arithmetic (including its final-step quirk), then a plain loop runs on
    the device of x0."""
    t, dts = 0.0, []
    while t < t_final:
        t += dt
        dts.append(min(dt, t_final - t))
    x = x0
    vc = prob.velocity_function(problem, x, bb_min, bb_max)
    for dti in dts:
        x = x + dti * vc
        vc = prob.velocity_function(problem, x, bb_min, bb_max)
    return x - x0
