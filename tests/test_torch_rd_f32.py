"""The f32 residual distribution (`-lo 3|4`, and `-mono` through it) of
remhos_torch: the regression tests of the normaliser fault.

The reference normalises the RD weights by nd*x_max - sum(u) + 1e-15
(remhos_tpu/lo.py:75-76, 88-89). In f32 that cancels to the 1e-15 on a
nearly constant element or subcell while the numerators x_max - u_i do
not, so the weights summed far above 1 and a step lost mass. The port
normalises each weight by the sum of its own numerators:

- on nearly constant elements and subcells the f32 weights sum to 1, so
  the LO rate's element sums equal those of its residual (to 1e-5 of the
  largest); an exactly constant element has none, as in the reference;
- one f32 step of `periodic-square -p 5 -rs 3 -dt 0.004 -ho 3 -lo 4
  -fct 0`, closure off, loses less than 1e-7 of the mass (the reference's
  formula lost 5.9e-4), assembled and with -pa;
- `transport-ballsjacks-m2` runs in the golden runner's `--f32` tier and
  matches under tests/test_f32_goldens.py's rule, with the closure's
  injected mass inside its 1e-4 budget (the tier reports it now).
"""

import json
import types

import numpy as np
import pytest
import torch

from remhos_torch import driver, lo
from remhos_torch.config import RunConfig
from remhos_torch.tools import run_goldens
from torch_threads import one_torch_thread  # noqa: F401


def test_weights_sum_to_one_in_f32():
    rng = np.random.default_rng(0)
    E, p = 64, 3
    nd = (p + 1) ** 2
    # a few dozen f32 ulps apart: the reference's normaliser keeps one or
    # two significant digits here
    u = (0.3 + 1e-6 * rng.random((E, nd))).astype(np.float32)
    z = rng.standard_normal((E, nd)).astype(np.float32)
    idx = np.arange(p + 1)
    sub2ind = np.array([[i + j * (p + 1), i + 1 + j * (p + 1),
                         i + (j + 1) * (p + 1), i + 1 + (j + 1) * (p + 1)]
                        for j in idx[:-1] for i in idx[:-1]])
    sub_w = rng.standard_normal((E, p * p, 4)).astype(np.float32)
    T = torch.as_tensor
    zero, one = torch.zeros(E, nd), torch.ones(E, nd)
    for kw in (dict(), dict(subcell=True, subcell_weights=T(sub_w),
                            sub2ind=T(sub2ind).long(), gamma=10.0)):
        du = lo.residual_distribution_core(T(u), T(z), zero, one, **kw)
        assert torch.isfinite(du).all()
        np.testing.assert_allclose(du.double().sum(1).numpy(),
                                   z.astype(np.float64).sum(1),
                                   rtol=0, atol=1e-5 * np.abs(z).sum(1).max())
    # an exactly constant element has no weights (as in the reference)
    du = lo.residual_distribution_core(T(np.full((1, nd), 0.3, np.float32)),
                                       T(z[:1]), zero[:1], one[:1])
    assert torch.equal(du, zero[:1])


@pytest.mark.parametrize("pa", [False, True])
def test_one_f32_step_conserves(pa):
    r = driver.run(RunConfig(
        mesh="periodic-square", problem=5, rs_levels=3, dt=0.004,
        t_final=0.8, ho=3, lo=4, fct=0, pa=pa, dtype="float32",
        closure=False, max_tsteps=1, verbose=False, device="cpu"))
    mass0 = r.final_mass_u + r.mass_loss_u
    assert r.mass_loss_u < 1e-7 * mass0
    assert r.max_u <= 1.0 + 1e-6


def test_ballsjacks_m2_in_the_f32_tier(capsys):
    assert run_goldens.main(["--device", "cpu", "--f32", "--only",
                             "transport-ballsjacks-m2"]) == 0
    out = capsys.readouterr().out
    rec = json.loads(out.strip().splitlines()[-1])
    assert rec["matched"] == ["transport-ballsjacks-m2"]
    assert "closure_injected_rel=" in out


def test_f32_tier_holds_the_closure_budget():
    row = dict(cfg=dict(fct=2), mass=1.0, max=1.0)
    r = types.SimpleNamespace(final_mass_u=1.0, max_u=1.0, steps=10,
                              mass_loss_u=0.0, mass_closure_injected_rel=0.0)
    assert run_goldens.check_row(row, r, True) == []
    r.mass_closure_injected_rel = 2 * run_goldens.CLOSURE_BUDGET
    assert any("closure" in m for m in run_goldens.check_row(row, r, True))
    assert run_goldens.check_row(row, r, False) == []
