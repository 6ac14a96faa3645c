"""Iterations per global mass CG solve of the non-fused stage over the
traced phases (the operator's `cg_stats`); each iteration reads one
comparison back to the host."""


def read(ctx):
    c = ctx.get("counters") or {}
    if not c.get("solves"):
        return None
    return c["iterations"] / c["solves"]
