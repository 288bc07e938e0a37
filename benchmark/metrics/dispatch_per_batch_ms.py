"""dispatch_per_batch_ms: the program's stage timer ``extract_dispatch_s``
(``compute_statistics``' observer: the main thread's dispatch of each
ingest batch), a traced job's mean, over the batches a job is given,
in milliseconds: the host's cost of one batch, which many shallow
samples multiply."""


def read(ctx):
    jobs = ctx.traced_jobs
    batches = ctx.shapes.get("batches")
    if (not jobs or not batches
            or any("extract_dispatch_s" not in j.timers for j in jobs)):
        return None
    per_job = sum(j.timers["extract_dispatch_s"] for j in jobs) / len(jobs)
    return 1e3 * per_job / batches
