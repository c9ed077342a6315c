"""Entry: the 95th percentile of every frame's latency, from issue to sync,
over the run's untraced window (the tail of a frame paced by the host)."""


def read(ctx):
    return ctx.window.p95_ms()
