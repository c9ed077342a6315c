"""Entry: host ms per frame inside ``volym.render``, the program's share of the
frame on the profiler's clock (the rest of ``host_ms.view`` is the caller's)."""

from perfbench import spans


def read(ctx):
    return spans.host_ms(ctx, [spans.RENDER])
