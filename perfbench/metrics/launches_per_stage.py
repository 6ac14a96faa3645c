"""Device operations launched per RK stage of the traced phases: every
kernel, copy and fill the trace holds, hand-written kernels and library
ops alike (the harness holds the trace's hand-kernel events against the
program's launch counters)."""


def read(ctx):
    tr = ctx.get("trace")
    if tr is None or not tr.events:
        return None
    return len(tr.events) / ctx["stages"]
