"""Device-trace capture and per-kernel attribution of the step loop.

The counterpart of `remhos_tpu/utils/trace.py`, on `torch.profiler` with its
CPU and CUDA activities. A trace of the real loop gives

- the device events (kernels, copies and fills) with their durations,
  measured by the device (CUPTI), not by the host clock;
- for each of them the `aten::` op that launched it: the innermost CPU op
  around the runtime call whose correlation id the device event carries.
  The port's kernels (`ops.KERNELS`) are launched through ctypes outside
  any aten op and are counted by their symbol names (`<name>_kernel`);
- the device's busy time (the union of the device events' intervals) and
  its idle share over the traced window.

The TPU module's `hbm_bytes_of_op` reads XLA's buffer placement tags, which
have no counterpart here: bytes per stage come from the analytic cost
functions of `utils/cost.py` instead.

Used by `bench.run(..., trace=True)` (kernel and glue time per stage, the
glue's top ops, idle share) and `utils/fom.py` (the phase ablation timed by
device time). The driver's `-prof` records its time loop with
`loop_profiler` and writes it with `write_loop_trace`.

The program's own spans live here too:

- `span(name)` marks a layer of the stepping path in the same Chrome trace,
  on the clock of the device events: `torch.profiler.record_function` while
  a profiler records (the `-prof` loop, `capture_trace`, a benchmark's
  traced phases), else one shared no-op object. There is no setting: spans
  record when a profiler does. The names: `remhos.step` (its self time the
  RK and Kahan combine), `remhos.stage` (on the fused path its self time
  is kernel 1's launch), `remhos.closure`, `remhos.geometry` (on the
  assembled stage > `remhos.assemble`, `remhos.factor`, `remhos.upwind`),
  `remhos.gather`, `remhos.bounds`, `remhos.ho` > `remhos.cg`, `remhos.lo`,
  `remhos.fct` (> `remhos.flux` with `-fct 1`), `remhos.product`,
  `remhos.mono` (the monolithic solution, with its explicit part,
  `mono_rd`'s launch or the plain chain, in its self time; >
  `remhos.bounds`, `remhos.si`, `remhos.lumping` (the neighbour gather),
  `remhos.mono_loop`; `remhos.si` also in `-fct 3`) and
  `remhos.sync`. A span's parent is the span around it on the same
  thread; a layer's self time is its span less its child spans
  (`device_by_span` and `idle_by_span` charge each instant to the
  innermost span);
- `host_wait(read, ...)` runs one read the host waits on the device for (a
  CG's stopping test, a closure's host-to-device copy, a read-back) inside
  a `remhos.sync` span; `loop_report` counts these spans.

Spans allocate nothing on the device and change no value.
"""

from __future__ import annotations

import contextlib
import functools
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
SPAN_PREFIX = "remhos."
# where a device event or an idle instant falls outside every program span
OUTSIDE = "(outside)"
_recording = torch._C._autograd._profiler_enabled
_no_span = contextlib.nullcontext()


def span(name):
    """The context manager that marks `name` (a `remhos.*` span) in the
    trace: `torch.profiler.record_function(name)` while a profiler records,
    else the shared no-op object (0.6 us an enter and exit on an H100
    machine's host; a `spanned` call 0.25 us more than a plain one)."""
    return torch.profiler.record_function(name) if _recording() else _no_span


def spanned(name):
    """Decorator: every call of the function runs inside span(name)."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if not _recording():
                return fn(*args, **kwargs)
            with torch.profiler.record_function(name):
                return fn(*args, **kwargs)
        return call
    return wrap


def host_wait(read, *args, **kwargs):
    """read(*args, **kwargs), a call that waits for the device, marked by a
    `remhos.sync` span."""
    with span("remhos.sync"):
        return read(*args, **kwargs)


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


def _thread(e):
    return (e.get("pid"), e.get("tid"))


def _runtime_calls(events):
    """{thread: [(ts, correlation id)]} of the CUDA runtime and driver
    calls."""
    calls = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in ("cuda_runtime",
                                                   "cuda_driver"):
            corr = e.get("args", {}).get("correlation")
            if corr is not None:
                calls.setdefault(_thread(e), []).append(
                    (float(e.get("ts", 0.0)), corr))
    return calls


def _enclosing(spans, calls):
    """{correlation id: the name of the innermost span around its call, or
    None}; spans {thread: [(ts, -end, name)]}, calls as `_runtime_calls`."""
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


def _launching_ops(events):
    """{correlation id: innermost `aten::` op around its runtime call}."""
    spans = {}
    for e in events:
        if (e.get("ph") == "X" and e.get("cat") == "cpu_op"
                and str(e.get("name")).startswith("aten::")):
            ts = float(e.get("ts", 0.0))
            spans.setdefault(_thread(e), []).append(
                (ts, -(ts + float(e.get("dur", 0.0))), e["name"]))
    return _enclosing(spans, _runtime_calls(events))


def device_ops(trace):
    """[{name, cat, ts, dur, corr, op, kernel}] of the device events: ts and
    dur in microseconds, corr the correlation id of the runtime call that
    launched it, op the launching `aten::` op (or None), kernel the port
    kernel (or None)."""
    ev = trace.get("traceEvents", [])
    launcher = _launching_ops(ev)
    out = []
    for e in ev:
        if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS:
            corr = e.get("args", {}).get("correlation")
            out.append(dict(name=e["name"], cat=e["cat"],
                            ts=float(e["ts"]), dur=float(e.get("dur", 0.0)),
                            corr=corr, op=launcher.get(corr),
                            kernel=port_kernel_of(e["name"])))
    return out


def kernel_events(trace):
    """{port kernel: number of its device events in the trace}."""
    out = dict.fromkeys(ops.KERNELS, 0)
    for o in device_ops(trace):
        if o["kernel"] is not None:
            out[o["kernel"]] += 1
    return out


def _union(intervals):
    """The merged, sorted intervals."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def program_spans(trace, name=None):
    """[(ts, end, name, thread)] of the program's spans (the `remhos.*`
    user annotations; only those called `name` if given), by start, in the
    trace's microseconds."""
    out = []
    for e in trace.get("traceEvents", []):
        n = str(e.get("name"))
        if (e.get("ph") == "X" and e.get("cat") == "user_annotation"
                and n.startswith(SPAN_PREFIX) and name in (None, n)):
            ts = float(e["ts"])
            out.append((ts, ts + float(e.get("dur", 0.0)), n, _thread(e)))
    return sorted(out)


def _main_thread(spans):
    """The thread that holds the most of `program_spans`' spans."""
    n = {}
    for *_, key in spans:
        n[key] = n.get(key, 0) + 1
    return max(n, key=n.get) if n else None


def _innermost_segments(spans):
    """[(a, b, name)]: the stretches of time in which `name` is the
    innermost of the nested spans [(a, b, name)] of one thread."""
    out, stack, t = [], [], None
    for a, b, name in sorted(spans, key=lambda x: (x[0], -x[1])):
        while stack and stack[-1][0] <= a:
            end, n = stack.pop()
            if end > t:
                out.append((t, end, n))
                t = end
        if stack:
            if a > t:
                out.append((t, a, stack[-1][1]))
            b = min(b, stack[-1][0])
        stack.append((b, name))
        t = a
    while stack:
        end, n = stack.pop()
        if end > t:
            out.append((t, end, n))
            t = end
    return out


def loop_window(trace):
    """(start, end) of a traced loop in the trace's microseconds: from the
    first start to the last end of any event but the profiler's own."""
    ev = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)))
          for e in trace.get("traceEvents", [])
          if e.get("ph") == "X" and "ts" in e
          and not e.get("name", "").startswith(_PROFILER_SPANS)]
    if not ev:
        return None
    return min(a for a, _ in ev), max(b for _, b in ev)


def _idle_us(trace, window):
    """The device's idle intervals in `window`."""
    busy = _union((max(o["ts"], window[0]), min(o["ts"] + o["dur"],
                                                window[1]))
                  for o in device_ops(trace)
                  if o["ts"] < window[1] and o["ts"] + o["dur"] > window[0])
    idle, t = [], window[0]
    for a, b in busy + [[window[1], window[1]]]:
        if a > t:
            idle.append((t, a))
        t = max(t, b)
    return idle


def device_by_span(trace):
    """{span: device seconds}: every device event charged to the innermost
    program span around the runtime call that launched it, else to
    OUTSIDE."""
    ev = trace.get("traceEvents", [])
    spans = {}
    for a, b, n, key in program_spans(trace):
        spans.setdefault(key, []).append((a, -b, n))
    launcher = _enclosing(spans, _runtime_calls(ev))
    acc = {}
    for o in device_ops(trace):
        n = launcher.get(o["corr"]) or OUTSIDE
        acc[n] = acc.get(n, 0.0) + 1e-6 * o["dur"]
    return acc


def idle_by_span(trace, window=None):
    """{span: idle seconds}: every instant of `window` ((start, end) in the
    trace's microseconds; `loop_window` by default) in which the device
    runs nothing, charged to the innermost program span open then on the
    thread that holds the most of them, else to OUTSIDE."""
    window = window or loop_window(trace)
    if window is None:
        return {}
    sp = program_spans(trace)
    main = _main_thread(sp)
    segs = _innermost_segments([(a, b, n) for a, b, n, k in sp if k == main])
    acc, j = {}, 0
    for x, y in _idle_us(trace, window):
        left = y - x
        while j < len(segs) and segs[j][1] <= x:
            j += 1
        k = j
        while k < len(segs) and segs[k][0] < y:
            a, b, n = segs[k]
            d = min(y, b) - max(x, a)
            acc[n] = acc.get(n, 0.0) + 1e-6 * d
            left -= d
            k += 1
        if left > 0:
            acc[OUTSIDE] = acc.get(OUTSIDE, 0.0) + 1e-6 * left
    return acc


def host_s_of_spans(trace, name="remhos.stage", less="remhos.sync"):
    """[seconds] of each span called `name`: its duration less the spans
    called `less` inside it on its thread (the host's own time in it, the
    waits for the device left out)."""
    waits = program_spans(trace, less)
    out = []
    for a, b, _, key in program_spans(trace, name):
        w = sum(min(d, b) - max(c, a) for c, d, _, k in waits
                if k == key and c < b and d > a)
        out.append(1e-6 * (b - a - w))
    return out


def loop_report(trace, n_calls, stages_per_call):
    """Attribute the device time of a traced loop of n_calls steps of
    stages_per_call stages. Per stage, in seconds:
      kernel      the port's kernels (by symbol name), also by kernel
      glue        every other device event, bucketed by the `aten::` op
                  that launched it ("(memcpy)"-style names where none did),
                  buckets sorted by time
      total       the sum of all device events
      by span     device time (`device_by_span`) and idle time
                  (`idle_by_span`) by the innermost program span, sorted
      host        the host's own time in a `remhos.stage` span (its
                  `remhos.sync` waits left out), over the stage spans
    and kernel_calls (events of the port's kernels, also by kernel), busy_s
    (the union of the device events' intervals), wall_s (the traced window,
    from the first start to the last end of any event), idle_share =
    1 - busy_s / wall_s, and host_syncs_per_call (the `remhos.sync` spans
    over n_calls)."""
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
    window = loop_window(trace)
    wall_us = window[1] - window[0] if window else 0.0
    busy_us = sum(b - a for a, b in _union((o["ts"], o["ts"] + o["dur"])
                                           for o in dev))
    s = 1e-6 / n_stages
    host = host_s_of_spans(trace)

    def per_stage(acc):
        return {k: v / n_stages for k, v in sorted(acc.items(),
                                                   key=lambda kv: -kv[1])}

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
        "device_s_per_stage_by_span": per_stage(device_by_span(trace)),
        "idle_s_per_stage_by_span": per_stage(idle_by_span(trace, window)),
        "host_s_per_stage": sum(host) / len(host) if host else None,
        "host_syncs_per_call": len(program_spans(trace, "remhos.sync"))
        / max(n_calls, 1),
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
