"""Look-ahead gate B7 (the bounds pass and the gate): device ms per frame."""

from perfbench import layers, spec


def read(ctx):
    return layers.mean_ms(ctx, spec.metric_data("gate_ms")["kernels"])
