"""`Advection.stage_function()` of the non-fused PA stage against
remhos_tpu's `Advection(use_pallas=True)` on the CPU, for the five (ho, lo)
pairs, one and two fields, on a 3D mesh, a 2D mesh and a periodic p = 2 mesh.

Set-up, inputs and tolerances are those of tests/test_torch_pa_operator.py
(dS <= 1e-10 * max|dS| in f64 with `-ho 3`, 1e-9 with `-ho 2`).
"""

import jax.numpy as jnp
import pytest

from test_torch_pa_operator import (DT, MESHES, PAIRS, T_STAGE, _check_stage,
                                    _kernel_counts, _operators, _tol, t64)
from torch_threads import one_torch_thread  # noqa: F401


# two fields on every mesh, one field on the two 2D meshes
@pytest.mark.parametrize("mesh,nfields", [(0, 2), (1, 2), (2, 2), (1, 1),
                                          (2, 1)])
@pytest.mark.parametrize("ho,lo", PAIRS)
def test_stage_function_matches_jax(mesh, nfields, ho, lo):
    shape, periodic, p = MESHES[mesh]
    jadv, adv, S = _operators(shape, periodic, p, 2, nfields, ho=ho, lo=lo,
                              product_sync=nfields == 2)
    before = _kernel_counts()
    res_t = adv.stage_function()(T_STAGE, DT, t64(S))
    assert before == _kernel_counts()           # CPU: plain versions only
    # one HO solve per field; the RD solutions solve nothing
    assert adv.cg_stats["solves"] == nfields
    assert adv.cg_stats["iterations"] >= 2 * nfields
    _check_stage(res_t, jadv.stage_function()(T_STAGE, DT, jnp.asarray(S)),
                 _tol(ho))
