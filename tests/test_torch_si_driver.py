"""`-fct 3 -si 1|2` through remhos_torch.driver.run, against
remhos_tpu.driver.run on the CPU.

tests/test_driver.py::test_nonlinear_penalty_sharpening cut to one step
against the JAX driver (final mass, max u and the L1 error to 1e-12; the
JAX run alone takes ~25 s here, most of it compiling), and that test's own
assertions on the port alone over two steps.
"""

from remhos_tpu import driver as jdriver
from remhos_tpu.config import RunConfig as JConfig

from remhos_torch import driver
from remhos_torch.config import RunConfig
from torch_threads import one_torch_thread  # noqa: F401

PENALTY = dict(mesh="periodic-square", problem=4, rs_levels=2, order=3,
               dt=0.005, t_final=0.05, ho=3, lo=3, fct=3, verbose=False)


def test_penalty_sharpening_driver_matches_jax():
    """-fct 3 -si 1 through both drivers, one step."""
    kw = dict(PENALTY, smth_ind=1, max_tsteps=1)
    rj = jdriver.run(JConfig(**kw))
    rt = driver.run(RunConfig(device="cpu", **kw))
    assert rt.steps == rj.steps == 1
    for a, b in ((rt.final_mass_u, rj.final_mass_u), (rt.max_u, rj.max_u),
                 (rt.l1_error, rj.l1_error)):
        assert abs(a - b) <= 1e-12 * abs(b)


def test_penalty_sharpening_port():
    """tests/test_driver.py::test_nonlinear_penalty_sharpening's assertions
    on the port, two steps: -si changes the solution, conserves, and the
    two indicator types differ."""
    kw = dict(PENALTY, max_tsteps=2, device="cpu")
    r0 = driver.run(RunConfig(**kw))
    r1 = driver.run(RunConfig(smth_ind=1, **kw))
    r2 = driver.run(RunConfig(smth_ind=2, **kw))
    assert r1.mass_loss_u < 1e-10 and r2.mass_loss_u < 1e-10
    assert abs(r1.final_mass_u - r0.final_mass_u) < 1e-10
    assert abs(r1.l1_error - r0.l1_error) > 1e-8
    assert abs(r2.l1_error - r1.l1_error) > 1e-10
