"""The 95th percentile of the wall time of every phase completed in the
window, each from its start to its result on the host, in ms."""

import statistics


def read(ctx):
    walls = ctx.get("walls")
    if not walls or len(walls) < 2:
        return None
    return 1e3 * statistics.quantiles(walls, n=100, method="inclusive")[94]
