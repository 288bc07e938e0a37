"""extract_dispatch_s: the program's stage timer ``extract_dispatch_s``
(``compute_statistics``' observer), summed over the traced jobs, over
their number."""


def read(ctx):
    jobs = ctx.traced_jobs
    if not jobs or any("extract_dispatch_s" not in j.timers for j in jobs):
        return None
    return sum(j.timers["extract_dispatch_s"] for j in jobs) / len(jobs)
