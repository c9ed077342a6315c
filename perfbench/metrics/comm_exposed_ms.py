"""Collectives: device ms per step on rank 0 in which an all-reduce kernel runs
and no other kernel does: the part of the exchange that the step's own work
does not hide."""

from perfbench import layers, spec


def read(ctx):
    return layers.exposed_ms(ctx, spec.metric_data("allreduce_ms")["kernels"])
