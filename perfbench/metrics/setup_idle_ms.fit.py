"""Frame set-up and autograd: device idle ms per step in the gaps between the
device's merged intervals whose midpoint lies in a set-up span.  Its notes:
``idle_by_span``, the idle ms per step by the innermost ``volym.*`` span at
each gap's midpoint (``outside_program`` where none runs), and
``item_idle_ms``, their sum: the step's idle ms."""

from perfbench import spans


def read(ctx):
    if ctx.trace is None or not ctx.items or not spans.intervals(ctx.trace, spans.SETUP):
        return None
    value, by_span, idle = spans.setup_idle(ctx)
    ctx.notes["idle_by_span"] = by_span
    ctx.notes["item_idle_ms"] = idle
    return value
