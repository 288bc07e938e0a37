"""h2d_wait_s: the program's stage timer ``h2d_wait_s``
(``compute_statistics``' observer: the main thread's spans
``simka.ingest.wait_h2d``, its waits for a shipped batch), summed over
the traced jobs, over their number; None where a job lacks it."""


def read(ctx):
    jobs = ctx.traced_jobs
    if not jobs or any("h2d_wait_s" not in j.timers for j in jobs):
        return None
    return sum(j.timers["h2d_wait_s"] for j in jobs) / len(jobs)
