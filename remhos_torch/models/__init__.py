"""Named problem setups: the reference's benchmark scenarios
(autotest/test.sh:40-63, README.md:214-257) as RunConfig factories. The
port's copy of `remhos_tpu.models`.

>>> from remhos_torch.models import get_case
>>> cfg = get_case("transport-ballsjacks", ho=2, lo=3, fct=2, pa=True)
>>> from remhos_torch.driver import run; run(cfg)
"""

from __future__ import annotations

from ..config import RunConfig

# scenario -> base kwargs (method selection via overrides)
CASES = {
    # autotest scenarios (autotest/test.sh)
    "remap-pacman": dict(mesh="inline-quad", problem=14, rs_levels=1,
                         dt=0.0015, t_final=0.75),
    "remap-cube3d": dict(mesh="cube01_hex", problem=10, rs_levels=1,
                         order=2, dt=0.02, t_final=0.7),
    "transport-1d": dict(mesh="periodic-segment", problem=0, rs_levels=5,
                         dt=0.001, t_final=1.0),
    "transport-ballsjacks": dict(mesh="periodic-square", problem=5,
                                 rs_levels=3, dt=0.004, t_final=0.8),
    "transport-hexagon": dict(mesh="periodic-hexagon", problem=7,
                              rs_levels=5, dt=0.005, t_final=2.5),
    "transport-ball3d": dict(mesh="ball-nurbs", problem=1, rs_levels=1,
                             dt=0.035, t_final=3.0),
    "product-remap": dict(mesh="inline-quad", problem=14, rs_levels=1,
                          dt=0.001, t_final=0.75, product_sync=True),
    "sharpen-ballsjacks": dict(mesh="periodic-square", problem=5,
                               rs_levels=3, dt=0.01, t_final=0.8,
                               bounds_type=1, dt_control=1),
    # steady monolithic (README runs 12/13)
    "steady-mono1": dict(mesh="periodic-square", problem=6, rs_levels=2,
                         order=1, dt=0.01, t_final=20.0, mono=1,
                         ode_solver=1),
    "steady-mono2": dict(mesh="periodic-square", problem=7, rs_levels=2,
                         order=1, dt=0.01, t_final=20.0, mono=1,
                         ode_solver=1),
}

# default method triad (the reference GPU path, remhos.cpp:391-397)
DEFAULT_METHOD = dict(ho=3, lo=5, fct=2)


def get_case(name: str, **overrides) -> RunConfig:
    """RunConfig for a named scenario; keyword arguments override any
    field, `device` included."""
    if name not in CASES:
        raise KeyError(f"unknown case '{name}' (have: {sorted(CASES)})")
    kw = dict(CASES[name])
    for k, v in DEFAULT_METHOD.items():
        kw.setdefault(k, v)
    kw.update(overrides)
    return RunConfig(**kw)
