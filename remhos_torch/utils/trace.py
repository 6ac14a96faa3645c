"""Device-trace capture and per-kernel attribution of the step loop.

The counterpart of `remhos_tpu/utils/trace.py`, on `torch.profiler` with its
CPU and CUDA activities. A trace of the real loop gives

- the device events (kernels, copies and fills) with their durations,
  measured by the device (CUPTI), not by the host clock;
- for each of them the `aten::` op that launched it: the innermost CPU op
  around the runtime call whose correlation id the device event carries.
  The port's seven kernels are launched through ctypes outside any aten op
  and are counted by their symbol names (`<name>_kernel`);
- the device's busy time (the union of the device events' intervals) and
  its idle share over the traced window.

The TPU module's `hbm_bytes_of_op` reads XLA's buffer placement tags, which
have no counterpart here: bytes per stage come from the analytic cost
functions of `utils/cost.py` instead.

Used by `bench.run(..., trace=True)` (kernel and glue time per stage, the
glue's top ops, idle share) and `utils/fom.py` (the phase ablation timed by
device time). The driver's `-prof` records its time loop with
`loop_profiler` and writes it with `write_loop_trace`.
"""

from __future__ import annotations

import json
import os
import re
import tempfile
import time

import torch

from .. import ops

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# the profiler's own spans (the session, the schedule's steps): not part of
# the traced window
_PROFILER_SPANS = ("PyTorch Profiler", "ProfilerStep")
# captures `capture_counted` takes at most before it gives up
CAPTURE_ATTEMPTS = 3
# seconds of host quiet that open the recorded cycle of `capture_trace`
CAPTURE_QUIET_S = 0.010
_KERNEL_RE = re.compile(r"([A-Za-z0-9_]+)_kernel(?![A-Za-z0-9_])")


def capture_trace(fn, quiet_s=CAPTURE_QUIET_S):
    """Run fn() under torch.profiler (CPU activity, and CUDA activity where
    there is a card; synchronized at the end) and return the parsed
    Chrome trace dict. fn runs twice, in a warm-up cycle whose events are
    dropped, then recorded. The recorded cycle opens with quiet_s seconds
    of host sleep, which adds no event: when its first launch followed the
    cycle's start at once, the profiler lost some or all of the cycle's
    kernel records in a few captures in a hundred on an H100, and 10 ms of
    quiet removed that (`tools/trace_drops.py` counts it)."""
    from torch.profiler import ProfilerActivity, profile, schedule
    cuda = torch.cuda.is_available()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts, schedule=schedule(
            wait=0, warmup=1, active=1, repeat=1)) as prof:
        for cycle in range(2):
            if cycle and quiet_s:
                time.sleep(quiet_s)
            fn()
            if cuda:
                torch.cuda.synchronize()
            prof.step()
    fd, path = tempfile.mkstemp(prefix="remhos_trace_", suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)
    finally:
        os.unlink(path)


def loop_profiler(device):
    """A started torch.profiler recording of the driver's time loop (-prof):
    CPU activity, and CUDA activity on the card."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    prof.start()
    return prof


def write_loop_trace(prof, profile_dir, device) -> str:
    """Stop `loop_profiler`'s recording (after the device's queued work) and
    write its Chrome trace into profile_dir; returns the file's path."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    prof.stop()
    os.makedirs(profile_dir, exist_ok=True)
    path = os.path.join(profile_dir,
                        f"remhos_loop_{os.getpid()}.pt.trace.json")
    prof.export_chrome_trace(path)
    return path


def port_kernel_of(name):
    """The port kernel ("mega_stage", ...) a device event's name is, or
    None."""
    for m in _KERNEL_RE.finditer(name):
        if m.group(1) in ops.KERNELS:
            return m.group(1)
    return None


def _launching_ops(events):
    """{correlation id: innermost `aten::` op around its runtime call}."""
    spans, calls = {}, {}
    for e in events:
        if e.get("ph") != "X":
            continue
        key = (e.get("pid"), e.get("tid"))
        ts = float(e.get("ts", 0.0))
        if (e.get("cat") == "cpu_op"
                and str(e.get("name")).startswith("aten::")):
            spans.setdefault(key, []).append(
                (ts, -(ts + float(e.get("dur", 0.0))), e["name"]))
        elif e.get("cat") in ("cuda_runtime", "cuda_driver"):
            corr = e.get("args", {}).get("correlation")
            if corr is not None:
                calls.setdefault(key, []).append((ts, corr))
    out = {}
    for key, cl in calls.items():
        sp = sorted(spans.get(key, []))      # parents before their children
        stack, i = [], 0
        for t, corr in sorted(cl):
            while i < len(sp) and sp[i][0] <= t:
                while stack and -stack[-1][1] <= sp[i][0]:
                    stack.pop()
                stack.append(sp[i])
                i += 1
            while stack and -stack[-1][1] < t:
                stack.pop()
            out[corr] = stack[-1][2] if stack else None
    return out


def device_ops(trace):
    """[{name, cat, ts, dur, op, kernel}] of the device events: ts and dur
    in microseconds, op the launching `aten::` op (or None), kernel the
    port kernel (or None)."""
    ev = trace.get("traceEvents", [])
    launcher = _launching_ops(ev)
    out = []
    for e in ev:
        if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS:
            corr = e.get("args", {}).get("correlation")
            out.append(dict(name=e["name"], cat=e["cat"],
                            ts=float(e["ts"]), dur=float(e.get("dur", 0.0)),
                            op=launcher.get(corr),
                            kernel=port_kernel_of(e["name"])))
    return out


def kernel_events(trace):
    """{port kernel: number of its device events in the trace}."""
    out = dict.fromkeys(ops.KERNELS, 0)
    for o in device_ops(trace):
        if o["kernel"] is not None:
            out[o["kernel"]] += 1
    return out


def _union_us(intervals):
    total, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def loop_report(trace, n_calls, stages_per_call):
    """Attribute the device time of a traced loop of n_calls steps of
    stages_per_call stages. Per stage, in seconds:
      kernel      the port's kernels (by symbol name), also by kernel
      glue        every other device event, bucketed by the `aten::` op
                  that launched it ("(memcpy)"-style names where none did),
                  buckets sorted by time
      total       the sum of all device events
    and kernel_calls (events of the port's kernels, also by kernel), busy_s
    (the union of the device events' intervals), wall_s (the traced window,
    from the first to the last end of any event) and idle_share =
    1 - busy_s / wall_s."""
    n_stages = max(n_calls * stages_per_call, 1)
    dev = device_ops(trace)
    kernel_us, total_us = 0.0, 0.0
    by_kernel_us = dict.fromkeys(ops.KERNELS, 0.0)
    by_kernel_n = dict.fromkeys(ops.KERNELS, 0)
    buckets = {}
    for o in dev:
        total_us += o["dur"]
        if o["kernel"] is not None:
            kernel_us += o["dur"]
            by_kernel_us[o["kernel"]] += o["dur"]
            by_kernel_n[o["kernel"]] += 1
            continue
        b = o["op"] or f"({o['cat']})"
        buckets[b] = buckets.get(b, 0.0) + o["dur"]
    spans = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)))
             for e in trace.get("traceEvents", [])
             if e.get("ph") == "X" and "ts" in e
             and not e.get("name", "").startswith(_PROFILER_SPANS)]
    wall_us = max(b for _, b in spans) - min(a for a, _ in spans) \
        if spans else 0.0
    busy_us = _union_us((o["ts"], o["ts"] + o["dur"]) for o in dev)
    s = 1e-6 / n_stages
    return {
        "kernel_s_per_stage": kernel_us * s,
        "kernel_calls": sum(by_kernel_n.values()),
        "kernel_calls_by_name": by_kernel_n,
        "kernel_s_per_stage_by_name": {k: v * s
                                       for k, v in by_kernel_us.items()},
        "glue_s_per_stage": (total_us - kernel_us) * s,
        "total_s_per_stage": total_us * s,
        "buckets_s_per_stage": {
            k: v * s for k, v in sorted(buckets.items(),
                                        key=lambda kv: -kv[1])},
        "busy_s": busy_us * 1e-6,
        "wall_s": wall_us * 1e-6,
        "idle_share": 1.0 - busy_us / wall_us if wall_us > 0 else None,
    }


def device_time_of_loop(trace):
    """Total device time (s): the sum of the device events' durations."""
    return 1e-6 * sum(o["dur"] for o in device_ops(trace))


def capture_counted(fn):
    """(trace, launches): the trace of fn() (`capture_trace`) and how far
    each port kernel's launch counter advanced in the recorded call. On the
    card the profiler has now and then dropped all the kernel records of a
    short session, the warm-up of `capture_trace` notwithstanding; a
    capture whose port-kernel events differ from the launch counters is
    taken again, up to CAPTURE_ATTEMPTS captures in all, and counted in
    `capture_counted.retakes`. The caller's check (`check_kernel_events`)
    holds the last one."""
    counts = {}

    def counted():
        before = ops.launch_counts()
        fn()
        after = ops.launch_counts()
        counts.update({k: after[k] - before[k] for k in after})

    for attempt in range(CAPTURE_ATTEMPTS):
        capture_counted.retakes += attempt > 0
        tr = capture_trace(counted)
        if kernel_events(tr) == counts:
            break
    return tr, counts


capture_counted.retakes = 0


def check_kernel_events(trace, launches, what):
    """Raise unless the trace holds, for every port kernel, as many device
    events as its launch counter advanced (`launches`, capture_counted's):
    the profiler sees every kernel launched through ctypes."""
    events = kernel_events(trace)
    if events != launches:
        raise RuntimeError(f"{what}: the trace has kernel events {events}, "
                           f"the launch counters say {launches}")
    return events
