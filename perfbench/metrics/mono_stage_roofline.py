"""The monolithic transport stage as a whole against its roofline: the
least time of its work (perfbench/yardstick_mono.py: the geometry, the
element matrices, the bounds, the -si 2 indicator, K u with the limiters,
the nonlinear flux lumping, the residual distribution and the combine)
against the device's busy time per stage (the union of its operations'
intervals), in %. It counts the same work whatever carries it out, so
work removed from the stage or fused raises it."""

from perfbench import yardstick_mono as ym


def read(ctx):
    tr = ctx.get("trace")
    if tr is None or not tr.busy_s():
        return None
    least = ym.least_stage_seconds(ctx["sizes"])
    return 100.0 * least / (tr.busy_s() / ctx["stages"])
