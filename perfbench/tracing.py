"""The device trace of the traced phases, and what the per-layer readers take
from it.

A frozen copy of the program's trace reading: `torch.profiler` with its CPU
and CUDA activities, the Chrome trace parsed for the device events
(kernels, copies and fills, timed by the device through CUPTI), and for
each the `aten::` op whose runtime call launched it (the innermost CPU op
around the call with the event's correlation id). The program's
hand-written kernels are launched through ctypes outside any `aten::` op
and are known by their symbol names, `<kernel>_kernel`.

The traced window is the span from the start of the first traced phase to
the end of the last (the benchmark marks each phase with a
`record_function` span). The capture runs the traced phases twice and keeps
the second cycle, which opens with 10 ms of host quiet: a cycle that
launched at once lost kernel records in a few captures in a hundred on an
H100.
"""

from __future__ import annotations

import json
import os
import re
import tempfile
import time

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
PHASE_SPAN = "perfbench.phase"
QUIET_S = 0.010
_KERNEL_RE = re.compile(r"([A-Za-z0-9_]+)_kernel(?![A-Za-z0-9_])")


def capture(fn):
    """The parsed Chrome trace of the second of two runs of fn() under
    torch.profiler (CPU and CUDA activities, synchronized at the end)."""
    from torch.profiler import ProfilerActivity, profile, schedule
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts, schedule=schedule(
            wait=0, warmup=1, active=1, repeat=1)) as prof:
        for cycle in range(2):
            if cycle:
                time.sleep(QUIET_S)
            fn()
            torch.cuda.synchronize()
            prof.step()
    fd, path = tempfile.mkstemp(prefix="perfbench_trace_", suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)
    finally:
        os.unlink(path)


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


def _union(intervals):
    """The merged, sorted intervals."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


class Trace:
    """The device events of a capture and the traced window.

    `events`: [{name, cat, ts, dur (microseconds), op, kernel, label}],
    kernel the program's hand-written kernel (one of `kernels`) or None,
    label the kernel's name, else the launching op, else "(<cat>)"."""

    def __init__(self, trace, kernels):
        ev = trace.get("traceEvents", [])
        self.kernels = tuple(kernels)
        launcher = _launching_ops(ev)
        self.events = []
        for e in ev:
            if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
                continue
            kernel = next((m.group(1) for m in _KERNEL_RE.finditer(e["name"])
                           if m.group(1) in kernels), None)
            op = launcher.get(e.get("args", {}).get("correlation"))
            self.events.append(dict(
                name=e["name"], cat=e["cat"], ts=float(e["ts"]),
                dur=float(e.get("dur", 0.0)), op=op, kernel=kernel,
                label=kernel or op or f"({e['cat']})"))
        phases = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)))
                  for e in ev if e.get("ph") == "X"
                  and e.get("cat") == "user_annotation"
                  and e.get("name") == PHASE_SPAN]
        self.n_phases = len(phases)
        self.window = ((min(a for a, _ in phases), max(b for _, b in phases))
                       if phases else None)
        w = self.window
        self.busy = _union(
            (max(o["ts"], w[0]), min(o["ts"] + o["dur"], w[1]))
            for o in self.events
            if w is not None and o["ts"] < w[1] and o["ts"] + o["dur"] > w[0])

    def window_s(self):
        return 1e-6 * (self.window[1] - self.window[0]) if self.window else 0.0

    def busy_s(self):
        return 1e-6 * sum(b - a for a, b in self.busy)

    def kernel_counts(self):
        """{hand-written kernel: its device events}."""
        out = dict.fromkeys(self.kernels, 0)
        for o in self.events:
            if o["kernel"] is not None:
                out[o["kernel"]] += 1
        return out

    def durations(self, kernel):
        """Device microseconds of each event of one hand-written kernel."""
        return [o["dur"] for o in self.events if o["kernel"] == kernel]

    def device_ops(self, top=10):
        """[[label, seconds]] of the labels that took most device time."""
        acc = {}
        for o in self.events:
            acc[o["label"]] = acc.get(o["label"], 0.0) + 1e-6 * o["dur"]
        return sorted(([k, v] for k, v in acc.items()),
                      key=lambda kv: -kv[1])[:top]

    def idle_gaps(self, top=10):
        """[[label, seconds]]: the device's idle time in the window, by what
        the host was issuing then (the label of the device event that ended
        each gap; the gap after the last one is "(end of phase)")."""
        if self.window is None:
            return []
        starts = sorted((o["ts"], o["label"]) for o in self.events)
        acc, t, i = {}, self.window[0], 0
        for a, b in self.busy + [[self.window[1], self.window[1]]]:
            if a > t:
                while i < len(starts) and starts[i][0] < a:
                    i += 1
                label = starts[i][1] if i < len(starts) else "(end of phase)"
                if a >= self.window[1]:
                    label = "(end of phase)"
                acc[label] = acc.get(label, 0.0) + 1e-6 * (a - t)
            t = max(t, b)
        return sorted(([k, v] for k, v in acc.items()),
                      key=lambda kv: -kv[1])[:top]
