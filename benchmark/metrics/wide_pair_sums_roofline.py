"""wide_pair_sums_roofline: the pair kernel's share of its least time
(``yardstick.pair_sums_bound``) in the wide cohort's cell, read by the
reader of ``pair_sums_roofline`` beside this file."""

import os

from benchmark import registry


def read(ctx):
    bench_dir = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return registry.reader("pair_sums_roofline", bench_dir)(ctx)
