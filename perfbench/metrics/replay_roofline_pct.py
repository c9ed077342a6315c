"""Replay B2 in a training step: its roofline's least time over its device time."""

from perfbench import layers, spec


def read(ctx):
    data = spec.metric_data("replay_roofline_pct")
    return layers.roofline_pct(ctx, "replay_roofline_pct", data["kernels"], data["work"])
