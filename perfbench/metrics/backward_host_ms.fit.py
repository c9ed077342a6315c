"""Backward kernels: host ms per step inside ``volym.backward`` (the replay, the
fold and their glue, on the autograd engine's thread).  Its note,
``engine_outside_backward_ms``, has the host ms per step of the autograd
engine's nodes outside it: the set-up's own backward and the loss's."""

from perfbench import spans


def read(ctx):
    value = spans.host_ms(ctx, [spans.BACKWARD])
    if value is not None:
        ctx.notes["engine_outside_backward_ms"] = spans.engine_outside_backward(ctx)
    return value
