"""March B1 in a training step (the forward, with its residual): its roofline's least time over its device time."""

from perfbench import layers, spec


def read(ctx):
    data = spec.metric_data("march_roofline_pct.fit")
    return layers.roofline_pct(ctx, "march_roofline_pct.fit", data["kernels"], data["work"])
