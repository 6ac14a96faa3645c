"""The frozen yardstick counts what the program's own cost model counts
today, from the cell's sizes alone."""

import pytest
import torch

from perfbench import yardstick as ys


def test_fused_stage_bytes_at_24():
    # bench.stage_bytes_model's 244.3 MB a stage at 24^3, p=3, float32
    assert round(ys.fused_stage_bytes(ys.Sizes(24, 3)) / 1e6, 1) == 244.3


@pytest.fixture(scope="module")
def case():
    from remhos_torch import bench
    return bench.build_case(n=4, order=3, device="cpu", n_steps=4)


def test_fused_stage_equals_the_programs_model(case):
    from remhos_torch import bench
    from remhos_torch.ops.stage_core import default_sweeps
    from remhos_torch.utils import cost
    s = ys.Sizes(4, 3)
    adv = case.adv
    want = cost.stage_cost(adv._stage_tables, adv._poly,
                           default_sweeps(torch.float32))
    assert ys.fused_stage_kernel(s) == want
    assert ys.fused_stage_bytes(s) == bench.stage_bytes_model(case)


@pytest.mark.parametrize("with_wdet", [False, True])
def test_geometry_convection_equals_the_programs_model(with_wdet):
    from remhos_torch.discretization import build_discretization
    from remhos_torch.mesh import make_cartesian_mesh
    from remhos_torch.ops.geom_conv import geom_conv_tables
    from remhos_torch.utils import cost
    mesh = make_cartesian_mesh(3, (4,) * 3, (0.0,) * 3, (1.0,) * 3,
                               (False,) * 3)
    disc = build_discretization(mesh, 3)
    tb = geom_conv_tables(disc, torch.float32, "cpu")
    xs = torch.as_tensor(mesh.x, dtype=torch.float32)
    u = torch.zeros(64, disc.nd)
    want = cost.geom_conv_cost(xs, u, tb, with_wdet=with_wdet)
    assert ys.geometry_convection_kernel(ys.Sizes(4, 3),
                                         with_wdet=with_wdet) == want
