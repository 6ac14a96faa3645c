"""Device microseconds per RK stage of every operation that is not one of
the program's hand-written kernels: the stage glue (library kernels,
copies and fills)."""


def read(ctx):
    tr = ctx.get("trace")
    if tr is None or not tr.events:
        return None
    return sum(o["dur"] for o in tr.events
               if o["kernel"] is None) / ctx["stages"]
