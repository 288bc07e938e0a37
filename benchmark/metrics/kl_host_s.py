"""kl_host_s: the program's stage timer ``kl_host_s`` (``compute_statistics``'
observer: the join's host sums of the Kullback-Leibler limbs, one Python
sum an N x N entry, span ``simka.join.kl_host``), summed over the traced
jobs, over their number."""


def read(ctx):
    jobs = ctx.traced_jobs
    if not jobs or any("kl_host_s" not in j.timers for j in jobs):
        return None
    return sum(j.timers["kl_host_s"] for j in jobs) / len(jobs)
