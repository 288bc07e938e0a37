"""extract_kmers_roofline: the extraction kernel's least time (its bytes
over the card's bandwidth) over its device time, a job's batches."""

from benchmark import yardstick


def read(ctx):
    t = ctx.trace
    dev_s = None if t is None else t.kernel_s("extract_kmers")
    if not dev_s:
        return None
    s = ctx.shapes
    n_words = -(-2 * s["k"] // 62)
    ms, _ = yardstick.bound(yardstick.extract_bytes(
        s["packed_bytes"], s["valid_bytes"], s["window_slots"], n_words)
        + (s["batches"] - 1) * 8 * 17)
    return 100.0 * ms / 1e3 * len(ctx.traced_jobs) / dev_s
