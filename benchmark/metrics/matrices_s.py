"""matrices_s: the benchmark's span around the program's
compute_all_matrices, summed over the traced jobs, over their number."""


def read(ctx):
    jobs = ctx.traced_jobs
    return sum(j.matrices_s for j in jobs) / len(jobs) if jobs else None
