"""Starting the ranks of a sharded run: `shard_map` runs one program over
the devices of one process and needs no counterpart of this module.

    spawn_run(cfg or [cfgs], nprocs, device)   # -> rank 0's RunResult(s)

starts `nprocs` processes with the `spawn` context, joins them in a process
group (`dist.init_process_group` with `init_method="file://<tmpdir>"`,
which needs no TCP port, and an explicit timeout), runs `driver.run` in each
rank and returns rank 0's result. A list of configurations runs in one
spawn, each on a subgroup of the first prod(shard_grid) ranks while the
others wait at a barrier: process start-up (several seconds for a few gloo
ranks) is paid once. On the CPU each rank takes one torch thread. The
parent polls its children: a rank that fails ends the run at once with its
traceback, and the whole run is bounded by `timeout`, so a hang fails in
seconds instead of eating a test run's time limit.

Backends:
- the CPU: gloo;
- CUDA with one rank per card (nprocs <= the cards): NCCL, rank r on card r;
- CUDA with more ranks than cards: gloo, every rank on cuda:0. NCCL refuses
  two ranks on one device, and gloo's slab exchanges and reductions are
  staged through host memory (`halo.ShardComm.staged_bytes`).

One rank needs no process at all: `in_process_group(device)` makes a group
of one in the calling process (NCCL on the card, gloo on the CPU), which is
how `driver.run` and the bench run a sharded configuration of one shard.
Under `torchrun` the group already exists and `driver.run` joins it.

`spawn(fn, nprocs, device, *args)` runs any picklable function of the
package the same way (the bench's sharded leg, `graft_entry`). On the card
it builds every CUDA library in the parent first, so that no two ranks run
nvcc for the same library.
"""

from __future__ import annotations

import contextlib
import datetime
import os
import queue as queue_mod
import shutil
import tempfile
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist

# the process group that sharded runs of this process use (None: the
# default group); set by `use_group`
_GROUP = [None]


def current_group():
    """The process group of this process's sharded runs (None: the default
    group), or False when no process group is initialized."""
    if not dist.is_initialized():
        return False
    return _GROUP[0]


@contextlib.contextmanager
def use_group(group):
    """Run sharded configurations of this process on `group`."""
    old = _GROUP[0]
    _GROUP[0] = group
    try:
        yield group
    finally:
        _GROUP[0] = old


def backend_for(device, nprocs: int) -> str:
    """gloo on the CPU and with more ranks than cards, NCCL otherwise."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and nprocs <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def _init(init_file, rank, nprocs, backend, timeout_s):
    dist.init_process_group(backend, init_method=f"file://{init_file}",
                            rank=rank, world_size=nprocs,
                            timeout=datetime.timedelta(seconds=timeout_s))


def init_from_env(device=None, timeout_s=300.0):
    """Join the process group a launcher such as torchrun describes in the
    environment (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT; LOCAL_RANK
    picks the card under NCCL)."""
    world = int(os.environ["WORLD_SIZE"])
    backend = backend_for(device, world)
    if backend == "nccl":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    elif torch.device("cuda" if device is None else device).type == "cpu":
        torch.set_num_threads(1)
    dist.init_process_group(backend, init_method="env://",
                            timeout=datetime.timedelta(seconds=timeout_s))


@contextlib.contextmanager
def in_process_group(device=None, timeout_s=300.0):
    """A process group of one rank in this process, destroyed on exit."""
    tmp = tempfile.mkdtemp(prefix="remhos_pg_")
    try:
        _init(os.path.join(tmp, "rendezvous"), 0, 1, backend_for(device, 1),
              timeout_s)
        try:
            yield
        finally:
            dist.destroy_process_group()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def shard_count(cfg) -> int:
    """The ranks a run configuration asks for (1: unsharded)."""
    grid = shard_grid_of(cfg)
    return 1 if grid is None else int(np.prod(grid))


def shard_grid_of(cfg):
    """The shard grid of a configuration (remhos_tpu/driver.py:202): its
    `shard_grid`, else (n_shards,) when n_shards > 1, else None."""
    if cfg.shard_grid:
        return tuple(int(n) for n in cfg.shard_grid)
    return (int(cfg.n_shards),) if cfg.n_shards > 1 else None


def _worker(rank, nprocs, init_file, backend, device, timeout_s, out,
            fn, args):
    """One rank: init the group, run fn(*args), report rank 0's value."""
    try:
        dev = torch.device("cuda" if device is None else device)
        if dev.type == "cpu":
            torch.set_num_threads(1)
        elif backend == "nccl":
            torch.cuda.set_device(rank)
        _init(init_file, rank, nprocs, backend, timeout_s)
        value = fn(*args)
        dist.barrier()
        if rank == 0:
            out.put(("ok", value))
        dist.destroy_process_group()
    except BaseException:
        out.put(("error", f"rank {rank}:\n{traceback.format_exc()}"))
        raise


def spawn(fn, nprocs: int, device=None, *args, timeout_s=600.0,
          init_dir=None):
    """fn(*args) in each of nprocs spawned ranks of a fresh process group;
    returns rank 0's value. Raises RuntimeError with the failing rank's
    traceback, or on `timeout_s`."""
    backend = backend_for(device, nprocs)
    if torch.device("cuda" if device is None else device).type == "cuda":
        # every library built here, once, before any rank could race nvcc
        from ..ops import build
        build.build_all()
    tmp = tempfile.mkdtemp(prefix="remhos_pg_", dir=init_dir)
    ctx = torch.multiprocessing.get_context("spawn")
    out = ctx.Queue()
    procs = [ctx.Process(target=_worker, daemon=True,
                         args=(r, nprocs, os.path.join(tmp, "rendezvous"),
                               backend, device, timeout_s, out, fn, args))
             for r in range(nprocs)]
    try:
        for p in procs:
            p.start()
        t_end = time.monotonic() + timeout_s
        while True:
            try:
                status, value = out.get(timeout=0.2)
                break
            except queue_mod.Empty:
                pass
            dead = [p for p in procs if p.exitcode not in (None, 0)]
            if dead:
                status, value = "error", (
                    f"rank {procs.index(dead[0])} exited with code "
                    f"{dead[0].exitcode}")
                try:
                    status, value = out.get(timeout=2.0)
                except queue_mod.Empty:
                    pass
                break
            if time.monotonic() > t_end:
                status, value = "error", f"timed out after {timeout_s} s"
                break
        if status != "ok":
            raise RuntimeError(f"sharded run of {nprocs} ranks failed: "
                               f"{value}")
        for p in procs:
            p.join(timeout=max(1.0, t_end - time.monotonic()))
        return value
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=5.0)
        shutil.rmtree(tmp, ignore_errors=True)


def run_configs(cfgs, counted=False):
    """In each rank: driver.run of every configuration on the subgroup of
    its first prod(shard_grid) ranks (the others wait); rank 0's results,
    with `counted` each as (RunResult, the kernels' launch counts, their
    variant counts) of the run on rank 0 (`ops.launch_counts`)."""
    from .. import ops
    from ..driver import run
    results = []
    size = dist.get_world_size()
    for cfg in cfgs:
        n = shard_count(cfg)
        if n > size:
            raise ValueError(f"a configuration of {n} shards in a group of "
                             f"{size} ranks")
        group = None if n == size else dist.new_group(list(range(n)))
        if dist.get_rank() < n:
            ops.reset_launch_counts()
            with use_group(group):
                r = run(cfg)
            results.append((r, ops.launch_counts(), ops.variant_counts())
                           if counted else r)
        dist.barrier()
    return results


def spawn_run(cfgs, nprocs: int, device=None, timeout_s=600.0,
              init_dir=None, counted=False):
    """driver.run of one configuration (or of a list, in one spawn) in
    nprocs ranks; rank 0's RunResult (or the list of them; with `counted`
    as `run_configs` gives them)."""
    single = not isinstance(cfgs, (list, tuple))
    res = spawn(run_configs, nprocs, device, [cfgs] if single else list(cfgs),
                counted, timeout_s=timeout_s, init_dir=init_dir)
    return res[0] if single else res
