"""join_s: the program's stage timer ``join_s``
(``compute_statistics``' observer), summed over the traced jobs, over
their number."""


def read(ctx):
    jobs = ctx.traced_jobs
    if not jobs or any("join_s" not in j.timers for j in jobs):
        return None
    return sum(j.timers["join_s"] for j in jobs) / len(jobs)
