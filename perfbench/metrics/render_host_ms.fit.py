"""Entry: host ms per step inside ``volym.render``, the program's share of the
step on the profiler's clock (the rest of ``host_ms.fit`` is the caller's)."""

from perfbench import spans


def read(ctx):
    return spans.host_ms(ctx, [spans.RENDER])
