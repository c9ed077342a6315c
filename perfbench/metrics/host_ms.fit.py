"""Entry: host ms per step from issue to the return of the step's calls (render, loss, backward, the optimizer's step and the projection),
before the sync, over the run's untraced window."""


def read(ctx):
    return ctx.window.host_ms()
