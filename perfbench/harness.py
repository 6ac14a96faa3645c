"""One run of one cell: set-up, the measured window or the traced phases,
the comparison with the plain reference, and the result line.

Everything that belongs to one configuration, one traffic mix, one cell or
one metric is a file of its own, found by the names in BENCHMARK.json:

- configs/<config>.json: the solver options, the order, the float type,
  the entry module (entries/<entry>.py, which builds the program's operator
  and runs one phase) and the plain reference (reference/<reference>.py:
  `points(config, traffic, device)` where the initial fields are sampled,
  and `Reference(config, traffic, device)` with `phase(S0)`, `mass(t, u)`
  and `t_end`);
- traffic/<traffic>.json: the mesh size, the steps of a phase, dt and the
  features of the seeded initial field (`traffic.py` reads it);
- cells/<cell>.json: the configuration and traffic of a cell, its limits of
  the numbers `correct` compares (checks/<check>.py: `value(state, S0, want,
  ref)`) and how many phases it warms up, samples and traces;
- metrics/<metric>.py: `read(ctx)` -> the metric's value, or None where the
  run has nothing to read for it (the metric is then left out).

A phase is one remap: `steps` RK3 steps from the seeded initial fields at
pseudo-time 0, ended by a read-back to the host. The window is a closed
loop of one client: the next phase starts when the last one returns, until
`seconds` have passed; the phase in flight at the close runs to its end and
is not counted.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import random
import sys
import time
from pathlib import Path

import torch

from perfbench import traffic as trf
from perfbench import tracing
from perfbench.yardstick import Sizes

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "remhos_tpu")
# RK stages a step, by `ode_solver`: forward Euler, RK2, RK3-SSP, RK4
RK_STAGES = {1: 1, 2: 2, 3: 3, 4: 4}


def load_json(path):
    return json.loads(Path(path).read_text())


def module_at(path):
    """The Python module in the file at `path`, loaded by its path."""
    spec = importlib.util.spec_from_file_location(
        "perfbench_" + path.stem.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules():
    """The top-level names of FORBIDDEN that sys.modules holds."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


class Cell:
    """A workload of BENCHMARK.json with its files."""

    def __init__(self, name, root=ROOT):
        bench = load_json(root / "BENCHMARK.json")
        w = next((w for w in bench["workloads"] if w["name"] == name), None)
        if w is None:
            raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
        self.name, self.workload = name, w
        self.cell = load_json(HERE / "cells" / f"{name}.json")
        if (self.cell["config"], self.cell["traffic"]) != (w["config"],
                                                          w["traffic"]):
            raise SystemExit(f"cells/{name}.json names another configuration"
                             " or traffic than BENCHMARK.json")
        self.config = load_json(HERE / "configs" / f"{w['config']}.json")
        self.traffic = load_json(HERE / "traffic" / f"{w['traffic']}.json")
        self.metrics = {
            kind: [m for m in bench[kind]
                   if name in m.get("workloads", [name])]
            for kind in ("end_to_end", "per_layer")}

    @property
    def steps(self):
        return self.traffic["steps_per_remap"]

    def sizes(self):
        c = self.config
        itemsize = torch.empty((), dtype=getattr(torch, c["dtype"])
                               ).element_size()
        return Sizes(self.traffic["n"], c["order"], c["dim"],
                     c["mesh_order"], itemsize)

    def reference(self):
        """The configuration's plain reference module."""
        return module_at(HERE / "reference" / f"{self.config['reference']}.py")



def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def window(entry, seconds, k, rng):
    """(walls of the completed phases, a uniform sample of k of their
    results drawn by `rng`, phases started)."""
    walls, sample, started = [], [], 0
    close = time.perf_counter() + seconds
    while True:
        a = time.perf_counter()
        if a >= close:
            break
        res = entry.phase()
        started += 1
        b = time.perf_counter()
        if b > close:
            break
        walls.append(b - a)
        if len(sample) < k:
            sample.append(res)
        else:
            j = rng.randrange(len(walls))
            if j < k:
                sample[j] = res
    return walls, sample, started


def traced(entry, n_phases, kernels, attempts=3):
    """(Trace, results, launches, counters) of n_phases phases captured
    under the profiler. The launch counters and the program's counters
    advance over the recorded cycle; a capture whose hand-kernel events
    differ from the launch counters is taken again, up to `attempts`."""
    from remhos_torch import ops
    results, deltas = [], {}

    def fn():
        results.clear()
        before, c0 = ops.launch_counts(), entry.counters()
        for _ in range(n_phases):
            with torch.profiler.record_function(tracing.PHASE_SPAN):
                results.append(entry.phase())
        after, c1 = ops.launch_counts(), entry.counters()
        deltas["launches"] = {k: after[k] - before[k] for k in after}
        deltas["counters"] = {k: c1[k] - c0.get(k, 0) for k in c1}

    for _ in range(attempts):
        tr = tracing.Trace(tracing.capture(fn), kernels)
        if tr.kernel_counts() == deltas["launches"]:
            break
    return tr, list(results), deltas["launches"], deltas["counters"]


def _worst(x):
    """Sort key: a NaN is worse than any number."""
    return float("inf") if x != x else x


def run(cell, seed, seconds, trace, t_start, device="cuda", build=None):
    """The result of one run of `cell` (a Cell; the dict the result line
    prints), with the compared numbers under "checks". build(config,
    traffic, S0, device) makes the entry; by default the configuration's
    entry module's."""
    c, t = cell.config, cell.traffic
    cfg_c = cell.cell
    refmod = cell.reference()
    S0 = trf.initial_fields(refmod.points(c, t, device), t, seed,
                            c["solver"]["product_sync"])
    if build is None:
        build = module_at(HERE / "entries" / f"{c['entry']}.py").build
    entry = build(c, t, S0, device)
    for _ in range(cfg_c["warmup_phases"]):
        entry.phase()
    _sync(device)
    setup_s = time.perf_counter() - t_start
    stages = RK_STAGES[c["solver"]["ode_solver"]] * cell.steps
    ndofs = S0.shape[1] * S0.shape[2]
    ctx = dict(cell=cell, setup_s=setup_s, seconds=seconds,
               stages_per_phase=stages, ndofs=ndofs, sizes=cell.sizes())
    dev_info = {}
    if trace:
        from remhos_torch import ops
        tr, sample, launches, counters = traced(
            entry, cfg_c["trace_phases"], ops.KERNELS)
        attempted = len(sample)
        ctx.update(trace=tr, stages=stages * tr.n_phases, launches=launches,
                   counters=counters)
        dev_info = dict(busy_s=tr.busy_s(), window_s=tr.window_s())
        extra = dict(
            breakdown=dict(device_ops=tr.device_ops(),
                           idle_gaps=tr.idle_gaps()),
            trace_kernel_events=tr.kernel_counts(),
            launch_counts=launches)
    else:
        walls, sample, started = window(entry, seconds,
                                        cfg_c["sample_phases"],
                                        random.Random(seed))
        attempted = len(walls)
        ctx.update(walls=walls)
        extra = dict(phases_started=started)
    cuda = torch.device(device).type == "cuda"
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    ctx["peak_bytes"] = peak
    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in cell.metrics[kind]:
        v = module_at(HERE / "metrics" / f"{m['name']}.py").read(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    # the program's state goes before the reference runs
    states = [entry.state(r) for r in sample]
    del entry, sample, ctx
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    judge = refmod.Reference(c, t, device)
    want = judge.phase(S0)
    # each compared number per sampled phase; the run reports the worst
    per_phase = {
        k: [module_at(HERE / "checks" / f"{k}.py").value(s, S0, want, judge)
            for s in states]
        for k in cfg_c["limits"]}
    checks = {k: {"value": max(v, key=_worst) if v else None,
                  "limit": cfg_c["limits"][k]} for k, v in per_phase.items()}
    # a NaN is no number within its limit
    failed = sum(any(not per_phase[k][i] <= cfg_c["limits"][k]
                     for k in per_phase) for i in range(len(states)))
    name_dev = torch.cuda.get_device_name(device) if cuda else "cpu"
    return dict(
        correct=bool(states) and failed == 0,
        attempted=attempted, failed=failed, metrics=metrics,
        device=dict(platform="gpu" if cuda else "cpu", kind=name_dev,
                    count=1, memory_peak_bytes=peak, **dev_info),
        **extra, checks=checks)
