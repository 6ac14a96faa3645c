"""Kernel 4 (`geom_conv`, the stage geometry with the convection action,
without w_q det J as the non-fused stage calls it) against its roofline:
the least time of its work (perfbench/yardstick.py) over its mean device
time in the trace, in %."""

from perfbench import yardstick as ys


def read(ctx):
    tr = ctx.get("trace")
    durs = tr.durations("geom_conv") if tr is not None else []
    if not durs:
        return None
    least = ys.least_seconds(*ys.geometry_convection_kernel(ctx["sizes"]))
    return 100.0 * least / (1e-6 * sum(durs) / len(durs))
