"""The cases of the port's `unported` tests, by the ROADMAP.md item each
was written for.

Items 8 (general mesh files), 9 (output and the profiler) and 10
(sharding) are closed: a mesh name that is neither a registry mesh nor a
file raises FileNotFoundError; an output option runs and writes its files;
a sharded configuration runs over its ranks (spawned gloo processes here)
and equals the unsharded run to 1e-12 (`-dcn` without shards is an
unsharded run), except that `-mono` and `-si` with shards raise
NotImplementedError, as the JAX package does. A case that combines any of
these with a solver the JAX package rejects raises ValueError. Call it with
the working directory set to a temporary one: the output lands there.
"""

import dataclasses

import os

import pytest

from remhos_torch import driver
from remhos_torch.mesh import registry_dim
from remhos_torch.operator import solver_rejected


def check_item_case(cfg, item):
    if item == "Queue 1, item 10":
        sharded = cfg.n_shards > 1 or cfg.shard_grid is not None
        dim = cfg.dim if cfg.mesh == "default" else registry_dim(cfg.mesh)
        why = solver_rejected(driver._solver_config(cfg, dim))
        if why is not None:
            with pytest.raises(ValueError, match=why[:20]):
                driver.run(cfg)
        elif sharded and (cfg.mono or cfg.smth_ind):
            with pytest.raises(NotImplementedError, match="single-shard"):
                driver.run(cfg)
        else:
            r = driver.run(cfg)
            r1 = driver.run(dataclasses.replace(cfg, n_shards=1,
                                                shard_grid=None, dcn=False))
            assert r.shards == (2 if sharded else 1)
            assert r.steps_total == r1.steps_total >= 1
            assert abs(r.final_mass_u - r1.final_mass_u) <= 1e-12
            assert abs(r.max_u - r1.max_u) <= 1e-12
        return
    if item == "Queue 1, item 8":
        with pytest.raises(FileNotFoundError, match="no such file"):
            driver.run(cfg)
        return
    assert item == "Queue 1, item 9"
    dim = cfg.dim if cfg.mesh == "default" else registry_dim(cfg.mesh)
    why = solver_rejected(driver._solver_config(cfg, dim))
    if why is not None:
        with pytest.raises(ValueError, match=why[:20]):
            driver.run(cfg)
        return
    r = driver.run(cfg)
    assert r.steps_total >= 1
    if cfg.save:
        for f in ("meshHO_final.mesh", "sltn_final.gf", "sltn_final.npz"):
            assert os.path.getsize(f) > 0
    if cfg.visit:
        assert os.path.exists(f"{cfg.visit_prefix}_000000.mfem_root")
        assert os.path.exists(f"{cfg.visit_prefix}_000001.mfem_root")
    if cfg.profile_dir:
        assert r.trace_path.startswith(cfg.profile_dir)
        assert os.path.getsize(r.trace_path) > 0
