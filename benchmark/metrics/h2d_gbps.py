"""h2d_gbps: the H2D copies' achieved rate, GB/s: a job's packed and
valid-bits bytes (the batches the jobs are given, each shipped once a
job: the program's counter ``h2d_bytes``) over the program's stage
timer ``h2d_s`` (the ship worker's ``simka.ingest.h2d`` spans), a
traced job's mean."""


def read(ctx):
    jobs = ctx.traced_jobs
    if not jobs or any("h2d_s" not in j.timers for j in jobs):
        return None
    h2d_s = sum(j.timers["h2d_s"] for j in jobs) / len(jobs)
    if not h2d_s:
        return None
    s = ctx.shapes
    return (s["packed_bytes"] + s["valid_bytes"]) / h2d_s / 1e9
