"""Sharded runs of the port (gloo ranks on the CPU) against its unsharded
runs and against the JAX package's sharded runs (the conftest gives JAX 8
virtual devices), to 1e-13 in final mass and max u (f64).

Four of the configurations are also held against the JAX package's
sharded runs here, five more in tests/test_torch_sharded_jax.py.

The configurations are those of the JAX package's tests/test_sharded.py,
test_sharded_pallas.py and test_sharded_odd.py at their sizes: 4 and 8
ranks, the 2-D shard grids (2, 2), (2, 3), (2, 4) and (4, 2), the
assembled path's -lo 1|3|4|5, -bt 1, -ps with IDP-RK (-s 12), -pa with the
mega stage in 2D and 3D (kernel 1's "E" variant, its plain version here),
the non-mega fused stage under -dtc 1 and under IDP, the PA residual
distribution, the weak-scaling mesh, -dcn, and a checkpoint saved at 4
ranks and resumed at 2. Odd counts and the general route are in
tests/test_torch_sharded_general.py.

All the sharded runs of this module go through ONE spawn of 8 ranks
(`parallel.launch.spawn_run` with a list: each configuration on the first
prod(shard_grid) ranks), so process start-up is paid once.
"""

import pytest

from remhos_tpu.config import RunConfig as JConfig
from remhos_tpu.driver import run as jrun

from remhos_torch.config import RunConfig
from remhos_torch.driver import run
from remhos_torch.parallel import launch
from torch_threads import one_torch_thread  # noqa: F401

KW3D = dict(mesh="cube01_hex", problem=10, rs_levels=1, order=2, dt=0.02,
            t_final=0.7, max_tsteps=3, ho=3, lo=5, fct=2)
KW2D = dict(mesh="inline-quad", problem=14, rs_levels=2, order=3,
            dt=0.0015, t_final=0.75, max_tsteps=4, ho=3, lo=5, fct=2)
SQ = dict(mesh="periodic-square", problem=4, rs_levels=3, order=2,
          dt=0.005, t_final=0.02, ho=3, lo=5, fct=2)

# name -> (shard keywords, run keywords)
CASES = {
    "transport_periodic_8": (dict(n_shards=8), dict(SQ, order=3,
                                                    t_final=0.025)),
    "rd_nonperiodic_4": (dict(n_shards=4), dict(
        KW2D, dt=0.0015, max_tsteps=6, lo=3)),
    "remap_massbased_4": (dict(n_shards=4), dict(KW3D, max_tsteps=4)),
    "sparsity_bounds_8": (dict(n_shards=8), dict(SQ, bounds_type=1)),
    "discrete_upwind_8": (dict(n_shards=8), dict(SQ, lo=1, fct=4)),
    "product_idp_4": (dict(n_shards=4), dict(
        KW2D, dt=0.005, product_sync=True, ode_solver=12)),
    "grid_2x3_transport": (dict(shard_grid=(2, 3)), dict(
        mesh="periodic-cube", problem=0, rs_levels=1, order=2, dt=0.015,
        t_final=2.0, max_tsteps=6, ho=3, lo=5, fct=2)),
    "grid_2x2_remap_lo3": (dict(shard_grid=(2, 2)), dict(KW3D, lo=3,
                                                         max_tsteps=4)),
    "grid_2x4_pa": (dict(shard_grid=(2, 4)), dict(SQ, order=3, pa=True)),
    "grid_4x2_sparsity": (dict(shard_grid=(4, 2)), dict(SQ,
                                                        bounds_type=1)),
    "mega_3d_4": (dict(n_shards=4), dict(KW3D, pa=True)),
    "mega_3d_2x2": (dict(shard_grid=(2, 2)), dict(KW3D, pa=True)),
    "mega_2d_4": (dict(n_shards=4), dict(KW2D, pa=True)),
    # -dtc 1 compares max_tsteps only after an accepted step: dt = 0.001
    # reaches the 5th attempt with one accepted (dt = 0.02 rolls back past
    # it and runs ~1,800 steps, in the JAX package too)
    "fused_dtc_4": (dict(n_shards=4), dict(KW3D, pa=True, dt_control=1,
                                           dt=0.001, max_tsteps=5)),
    "fused_idp_4": (dict(n_shards=4), dict(KW3D, pa=True, ode_solver=12)),
    "pa_rd_4": (dict(n_shards=4), dict(KW3D, pa=True, lo=3)),
    "pa_subcell_4": (dict(n_shards=4), dict(KW2D, pa=True, lo=4,
                                            max_tsteps=3)),
    "subcell_rd_2": (dict(n_shards=2), dict(
        mesh="inline-quad", problem=14, rs_levels=1, order=2, dt=0.01,
        t_final=1.0, max_tsteps=4, ho=3, lo=4, fct=2)),
    "mega_bt1_4": (dict(n_shards=4), dict(KW3D, pa=True, bounds_type=1)),
    "dcn_4": (dict(n_shards=4, dcn=True), dict(KW3D, pa=True)),
    "weak_scaling_8": (dict(n_shards=8), dict(
        mesh="default", dim=2, elem_per_shard=32, problem=0, order=2,
        dt=0.005, t_final=0.02, ho=3, lo=5, fct=2)),
}
# the JAX package's sharded runs held against the port's here: a 2-D grid
# other than (2, 2), IDP-RK with -ps, -dtc 1 and the 3D mega stage on a
# (2, 2) grid; tests/test_torch_sharded_jax.py holds 8 ranks, -bt 1 and
# -lo 1|3|4 (two files: the JAX runs take ~5 s each)
JAX_CASES = ("mega_3d_2x2", "grid_2x3_transport", "product_idp_4",
             "fused_dtc_4")


def _cfg(name, sharded=True):
    shard, kw = CASES[name]
    if name == "weak_scaling_8" and not sharded:
        kw = dict(kw, elem_per_shard=32 * 8)
    return RunConfig(device="cpu", verbose=False,
                     **(shard if sharded else {}), **kw)


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    """{name: rank 0's RunResult} of every case, from one spawn of 8 ranks;
    the checkpoint pair's results under "checkpoint_4" / "resumed_2"."""
    ck = str(tmp_path_factory.mktemp("ck") / "state.npz")
    names = list(CASES)
    cfgs = [_cfg(n) for n in names]
    base = dict(KW3D, pa=True, device="cpu", verbose=False)
    del base["max_tsteps"]
    cfgs += [RunConfig(n_shards=4, checkpoint_path=ck, checkpoint_steps=2,
                       max_tsteps=2, **base),
             RunConfig(n_shards=2, checkpoint_path=ck, resume=True,
                       max_tsteps=4, **base)]
    res = launch.spawn_run(cfgs, 8, "cpu", timeout_s=300.0,
                           init_dir=str(tmp_path_factory.mktemp("pg")))
    out = dict(zip(names + ["checkpoint_4", "resumed_2"], res))
    out["_ck"] = ck
    return out


def _close(a, b, tol=1e-13):
    assert abs(a.final_mass_u - b.final_mass_u) < tol
    assert abs(a.max_u - b.max_u) < tol


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_equals_unsharded(name, sharded):
    rs = sharded[name]
    r1 = run(_cfg(name, sharded=False))
    assert rs.steps_total == r1.steps_total and rs.shards > 1
    _close(rs, r1)
    if CASES[name][1].get("product_sync"):
        assert abs(rs.final_mass_us - r1.final_mass_us) < 1e-13
        assert abs(rs.max_s - r1.max_s) < 1e-12
    assert rs.halo_staged_bytes == 0          # gloo on the CPU: no staging


@pytest.mark.parametrize("name", JAX_CASES)
def test_sharded_equals_jax_sharded(name, sharded):
    shard, kw = CASES[name]
    rj = jrun(JConfig(verbose=False, use_pallas=kw.get("pa", False),
                      **shard, **kw))
    _close(sharded[name], rj)


def test_checkpoint_saved_at_4_resumed_at_2(sharded):
    """4 ranks run 2 steps and save (in global element order); 2 ranks
    resume the file and run steps 3 and 4: the end equals 4 unsharded
    steps, and the file the unsharded state after 2."""
    a, b = sharded["checkpoint_4"], sharded["resumed_2"]
    assert a.steps_total == 2 and b.steps_total == 4
    base = dict(KW3D, pa=True, device="cpu", verbose=False)
    del base["max_tsteps"]
    _close(a, run(RunConfig(max_tsteps=2, **base)))
    _close(b, run(RunConfig(max_tsteps=4, **base)))
    from remhos_torch import checkpoint
    S, t, _, ti = checkpoint.load_state(sharded["_ck"])
    assert ti == 2 and S.shape[1] == 64
