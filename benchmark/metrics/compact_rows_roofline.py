"""compact_rows_roofline: the compaction kernel's least time over its
device time, a job's launches: one a batch (the kept windows' words, of
the batch's window slots) and one in the join (the solid rows' key and
int32 count, of the instances)."""

from benchmark import yardstick


def read(ctx):
    t = ctx.trace
    dev_s = None if t is None else t.kernel_s("compact_rows")
    if not dev_s:
        return None
    s = ctx.shapes
    n_words = -(-2 * s["k"] // 62)
    nbytes = (yardstick.compact_bytes(8 * n_words, s["window_slots"],
                                      s["instances"], False)
              + yardstick.compact_bytes(12, s["instances"], s["solid_rows"],
                                        False))
    ms, _ = yardstick.bound(nbytes)
    return 100.0 * ms / 1e3 * len(ctx.traced_jobs) / dev_s
