"""Collectives: device ms per step in NCCL's all-reduce kernels on rank 0 (every
tensor the step all-reduces, and the wait for the slowest rank, which the
kernel spends on the card)."""

from perfbench import layers, spec


def read(ctx):
    return layers.mean_ms(ctx, spec.metric_data("allreduce_ms")["kernels"])
