"""The fused stage as a whole against the memory roofline: the least bytes
of its work (kernel 1's, the gather, the bounds, the RK combine and the
closure; perfbench/yardstick.py) over the peak rate, against the device's
busy time per stage (the union of its operations' intervals), in %. It
counts the same work whatever carries it out, so fusing glue raises it."""

from perfbench import yardstick as ys


def read(ctx):
    tr = ctx.get("trace")
    if tr is None or not tr.durations("mega_stage") or not tr.busy_s():
        return None
    least = ys.fused_stage_bytes(ctx["sizes"]) / ys.PEAK_BYTES_PER_S
    return 100.0 * least / (tr.busy_s() / ctx["stages"])
