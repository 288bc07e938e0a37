"""job_p90_s: the 90th percentile of the wall of every job of the window."""

import statistics


def read(ctx):
    walls = [j.wall_s for j in ctx.jobs if j.error is None]
    return statistics.quantiles(walls, n=10)[-1] if len(walls) >= 2 else None
