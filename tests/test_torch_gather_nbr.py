"""remhos_torch.ops.gather_nbr against remhos_tpu's gather_nbr_flat on the
CPU, bit for bit.

The JAX side runs the Pallas kernel `gather_nbr_flat` in interpret mode on
the ten layouts of tests/test_gather_kernel.py (2D and 3D, one block, faces
whose offset is the whole block, every periodicity); the port runs the plain
version `gather_nbr_reference` through the wrapper (CPU tensors). Same
numpy u from a seed, in f64 and f32: the gather moves values and does no
arithmetic, so the outputs are equal, not close. A layout whose block size
(the last-axis stride) is not a multiple of 8, which the JAX meta rejects
(its caller falls back to XLA), is held against the port's own structured
gather and the JAX package's.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from remhos_tpu.dofmaps import build_dofmaps as jdofmaps
from remhos_tpu.mesh import make_mesh_from_breaks as jmesh
from remhos_tpu.ops import pallas_kernels as pk
from remhos_tpu.structured import gather_nbr_structured as jgather

from remhos_torch.dofmaps import build_dofmaps
from remhos_torch.ops import gather_nbr as gn
from remhos_torch.structured import gather_nbr_structured
from torch_threads import one_torch_thread  # noqa: F401

# tests/test_gather_kernel.py's CASES
CASES = [
    ((8, 5), (True, True), 2),
    ((8, 5), (False, False), 2),
    ((16, 3), (True, False), 3),
    ((16, 3), (False, True), 1),
    ((8, 1), (True, True), 2),
    ((8, 1), (False, False), 2),
    ((8, 4, 3), (True, True, True), 2),
    ((8, 4, 3), (False, False, False), 2),
    ((8, 2, 2), (False, True, True), 1),
    ((8, 2, 4), (True, False, False), 3),
]
# block sizes 6 and 15: not multiples of 8
ODD = [((6, 4), (True, True), 2), ((5, 3, 4), (False, True, False), 3)]
DTYPES = {torch.float64: jnp.float64, torch.float32: jnp.float32}


def _inputs(shape, periodic, p):
    dim = len(shape)
    breaks = tuple(np.linspace(0.0, 1.0, s + 1) for s in shape)
    jdm = jdofmaps(jmesh(dim, breaks, tuple(periodic), 1), p)
    nbr = np.asarray(jdm.nbr_dof_local)
    assert np.array_equal(nbr, build_dofmaps(dim, p).nbr_dof_local)
    rng = np.random.default_rng(int(np.prod(shape)) * 10 + p)
    u = rng.standard_normal((int(np.prod(shape)), jdm.nd))
    return u, nbr, jdm.nd


def _port(u, shape, periodic, nbr, dtype):
    before = gn.gather_nbr.launches
    out = gn.gather_nbr(torch.tensor(u, dtype=dtype),
                        gn.GatherLayout(shape, periodic, nbr, "cpu"))
    assert gn.gather_nbr.launches == before     # CPU: the plain version
    assert out.dtype == dtype
    return out


@pytest.mark.parametrize("shape,periodic,p", CASES)
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_gather_nbr_matches_pallas_kernel(shape, periodic, p, dtype):
    u, nbr, nd = _inputs(shape, periodic, p)
    u = np.asarray(u, dtype=np.float64 if dtype == torch.float64
                   else np.float32)
    meta = pk.gather_nbr_flat_meta(shape, tuple(periodic), nbr, nd)
    ref = np.asarray(pk.gather_nbr_flat(jnp.asarray(u, DTYPES[dtype]), meta))
    out = _port(u, shape, periodic, nbr, dtype)
    assert out.shape == ref.shape
    np.testing.assert_array_equal(out.numpy(), ref)


@pytest.mark.parametrize("shape,periodic,p", ODD)
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_gather_nbr_layout_the_tpu_meta_rejects(shape, periodic, p, dtype):
    u, nbr, nd = _inputs(shape, periodic, p)
    assert pk.gather_nbr_flat_meta(shape, tuple(periodic), nbr, nd) is None
    out = _port(u, shape, periodic, nbr, dtype)
    ut = torch.tensor(u, dtype=dtype)
    own = gather_nbr_structured(ut, shape, periodic, nbr).reshape(
        ut.shape[0], -1)
    assert torch.equal(out, own)
    jref = np.asarray(jgather(jnp.asarray(ut.numpy()), shape,
                              tuple(periodic), nbr)).reshape(ut.shape[0], -1)
    np.testing.assert_array_equal(out.numpy(), jref)


def test_gather_nbr_refuses_bad_operands():
    u, nbr, _ = _inputs((8, 5), (True, True), 2)
    ut = torch.tensor(u)
    with pytest.raises(ValueError, match="u must be"):
        gn.gather_nbr(ut[:-1], gn.GatherLayout((8, 5), (True, True), nbr,
                                               "cpu"))
    with pytest.raises(ValueError, match="nbr_dof_local must be"):
        gn.GatherLayout((8, 5), (True, True), nbr[:3], "cpu")
