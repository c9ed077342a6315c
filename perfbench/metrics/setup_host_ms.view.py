"""Frame set-up and autograd: host ms per frame in the union of the set-up spans
(``volym.grids``, ``volym.ray_table``, ``volym.cone_table``).  Its note,
``span_host_ms``, has every ``volym.*`` span's host ms per frame, total and self."""

from perfbench import spans


def read(ctx):
    value = spans.host_ms(ctx, spans.SETUP)
    if value is not None:
        ctx.notes["span_host_ms"] = spans.span_host_ms(ctx)
    return value
