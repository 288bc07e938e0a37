"""sort_roofline: the join's torch.sort of the packed (k-mer, sample)
keys, its least time (16 B a key) over its device time, a job's sort."""

from benchmark import yardstick


def read(ctx):
    t = ctx.trace
    dev_s = None if t is None else t.sort_s()
    if not dev_s:
        return None
    ms, _ = yardstick.bound(yardstick.sort_bytes(ctx.shapes["instances"]))
    return 100.0 * ms / 1e3 * len(ctx.traced_jobs) / dev_s
