"""pair_sums_roofline: the pair kernel's least time (the larger of its
bytes and its operations, yardstick.pair_sums_bound) over its device
time, a job's launch."""

from benchmark import yardstick


def read(ctx):
    t = ctx.trace
    dev_s = None if t is None else t.kernel_s("pair_sums")
    if not dev_s:
        return None
    s = ctx.shapes
    ms, _ = yardstick.pair_sums_bound(
        s["solid_rows"], s["kmers"], s["n_banks"], s["pairs"],
        yardstick.pair_channels(s["simple"], s["complex"]), s["complex"],
        s["sample_counts"])
    return 100.0 * ms / 1e3 * len(ctx.traced_jobs) / dev_s
