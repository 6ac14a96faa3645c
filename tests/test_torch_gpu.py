"""remhos_torch on the card: the CUDA kernel against its plain version and a
short verified run. Every test here is marked `gpu` and skips where
torch.cuda.is_available() is false.

This file imports neither jax nor remhos_tpu, so it also runs on a machine
without them:  python -m pytest tests/test_torch_gpu.py -m gpu --noconftest
"""

import numpy as np
import pytest
import torch

from remhos_torch import bench, bounds, structured
from remhos_torch.ops import mega_stage as ms

DT = 0.2 / 320


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.gpu
@pytest.mark.parametrize("dim,n", [(3, 5), (2, 9)])
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-10),
                                       (torch.float32, 2e-4)])
def test_kernel_matches_reference(dim, n, dtype, tol):
    """Kernel vs plain version, one stage, random u from a seed. Tolerances
    relative to max|du| as in chip_smoke.py: f64 round-off; f32 10x above
    the kernel's FMA ordering differences (~2e-5), below the ~2.5e-3 that a
    lost Jacobi sweep would make."""
    _cuda()
    case = bench.build_case(n=n, order=3, dtype=dtype, device="cuda",
                            n_steps=4, dt=DT, dim=dim)
    adv = case.adv
    rng = np.random.default_rng(7)
    u = torch.as_tensor(rng.random(tuple(case.u0.shape)), dtype=dtype,
                        device="cuda")
    unbr = adv.gather_nbr(u).reshape(u.shape[0], -1)
    smin, smax = structured.overlap_stencil_T(
        *bounds.elements_min_max(u), adv.shape, adv.periodic, adv.masks)
    args = (0.1, DT, u, unbr, smin, smax, adv._poly, adv._stage_tables)
    before = ms.mega_stage.launches
    got = ms.mega_stage(*args)
    torch.cuda.synchronize()
    assert ms.mega_stage.launches == before + 1
    ref = ms.mega_stage_reference(*args, ms.default_sweeps(dtype))
    err = (got - ref).abs().max().item()
    assert err <= tol * ref.abs().max().item()


@pytest.mark.gpu
def test_short_main_path():
    """8 verified RK3 steps through the kernel: 3 launches a step plus the
    cross check's 2 f32 and 2 f64 steps."""
    _cuda()
    case = bench.build_case(n=6, order=3, dtype=torch.float32,
                            device="cuda", n_steps=8, dt=DT)
    before = ms.mega_stage.launches
    rec = bench.run(case)
    assert ms.mega_stage.launches - before == 3 * 8 + 12
    assert rec["verified"] and rec["cross_check"]["status"] == "ran"
