"""Entry: host ms per frame from issue to the return of the render call,
before the sync, over the run's untraced window."""


def read(ctx):
    return ctx.window.host_ms()
