"""The assembled stage as a whole against its roofline: the least time of
its work (perfbench/yardstick_fa.py: the geometry, the element matrices,
the Cholesky factorization, the solves, DiscreteUpwind and one FluxBased
FCT sweep) against the device's busy time per stage (the union of its
operations' intervals), in %. It counts the same work whatever carries it
out, so work removed from the stage or fused raises it."""

from perfbench import yardstick_fa as yf


def read(ctx):
    tr = ctx.get("trace")
    if tr is None or not tr.busy_s() or ctx["cell"].config["solver"]["pa"]:
        return None
    least = yf.least_stage_seconds(ctx["sizes"])
    return 100.0 * least / (tr.busy_s() / ctx["stages"])
