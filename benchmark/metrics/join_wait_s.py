"""join_wait_s: the program's stage timer ``join_wait_s``
(``compute_statistics``' observer: the ``simka.sync.*`` spans inside
``simka.join``, where the join waits for the device), summed over the
traced jobs, over their number; None where a job lacks it."""


def read(ctx):
    jobs = ctx.traced_jobs
    if not jobs or any("join_wait_s" not in j.timers for j in jobs):
        return None
    return sum(j.timers["join_wait_s"] for j in jobs) / len(jobs)
