"""The cases of the port's `unported` tests, by the ROADMAP.md item each
was written for.

Queue 1 item 10 (sharding) is open: the run raises NotImplementedError
naming it. Items 8 (general mesh files) and 9 (output and the profiler) are
closed: a mesh name that is neither a registry mesh nor a file raises
FileNotFoundError, and an output option runs and writes its files, unless
the case combines it with a solver the JAX package rejects too, which
raises ValueError. Call it with the working directory set to a temporary
one: the output lands there.
"""

import os

import pytest

from remhos_torch import driver
from remhos_torch.mesh import registry_dim
from remhos_torch.operator import solver_rejected


def check_item_case(cfg, item):
    if item == "Queue 1, item 10":
        with pytest.raises(NotImplementedError, match="ROADMAP") as e:
            driver.run(cfg)
        assert item in str(e.value)
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
