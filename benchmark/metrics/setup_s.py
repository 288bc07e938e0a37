"""setup_s: from the run's start to the window's: the kernel build where
there is none yet, the community drawn, the samples parsed and packed,
and the warm-up jobs."""


def read(ctx):
    return ctx.setup_s
