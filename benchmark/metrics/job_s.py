"""job_s: the window's seconds over the jobs completed in it."""


def read(ctx):
    done = [j for j in ctx.jobs if j.error is None]
    return ctx.window_s / len(done) if done else None
