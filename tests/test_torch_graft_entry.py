"""The port's harness entry points (`remhos_torch.graft_entry`, the
counterpart of __graft_entry__.py) on the CPU:

- `entry("cpu")`: one RK3 step of the p=3 3D remap configuration, against
  the JAX entry's step on the same state (1e-12 of max|S|: the assembled
  path's Cholesky solves in another order);
- `dryrun_multichip(4, "cpu")`: the sharded step over 4 gloo ranks (a
  2 x 2 shard grid) against the unsharded step in the plain, production
  (-pa, kernel 1's "E" variant), weak-scaling and general-mesh legs, each
  < 1e-13;
- with no device both entries mean the card, and raise without one.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from remhos_torch import graft_entry
from torch_threads import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]


def test_entry_step_matches_jax():
    fn, args = graft_entry.entry("cpu")
    out = fn(*args)
    assert out.shape == args[0].shape
    sys.path.insert(0, str(ROOT))
    import jax
    import __graft_entry__ as ge
    jfn, jargs = ge.entry()
    ref = np.asarray(jax.jit(jfn)(*jargs))
    s0 = np.asarray(jargs[0])
    assert np.abs(args[0].numpy() - s0).max() <= 1e-14 * np.abs(s0).max()
    assert np.abs(out.numpy() - ref).max() <= 1e-12 * np.abs(ref).max()


def test_dryrun_multichip_4():
    out = graft_entry.dryrun_multichip(4, "cpu")
    assert out["grid"] == (2, 2)
    for k in ("plain", "production", "weak_scaling", "general_mesh"):
        assert out[k] < 1e-13


def test_entry_defaults_to_the_card(monkeypatch):
    """device=None means CUDA: without a card both entries raise at once
    instead of building a state on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (graft_entry.entry, lambda: graft_entry.dryrun_multichip(2)):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
