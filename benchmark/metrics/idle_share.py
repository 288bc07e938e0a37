"""idle_share: 100 x (1 - the union of the device's event intervals over
the traced window), from a trace that holds every counted launch."""


def read(ctx):
    t = ctx.trace
    if t is None or not t.complete():
        return None
    return 100.0 * (1.0 - t.busy_s() / t.window_s())
