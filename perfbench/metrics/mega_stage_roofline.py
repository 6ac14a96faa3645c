"""Kernel 1 (`mega_stage`, the fused limited stage) against its roofline:
the least time of its work (perfbench/yardstick.py) over its mean device
time in the trace, in %."""

from perfbench import yardstick as ys


def read(ctx):
    tr = ctx.get("trace")
    durs = tr.durations("mega_stage") if tr is not None else []
    if not durs:
        return None
    least = ys.least_seconds(*ys.fused_stage_kernel(ctx["sizes"]))
    return 100.0 * least / (1e-6 * sum(durs) / len(durs))
