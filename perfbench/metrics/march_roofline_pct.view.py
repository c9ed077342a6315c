"""March B1 in a frame: its roofline's least time over its device time, on the frames whose steps the reference counted."""

from perfbench import layers, spec


def read(ctx):
    data = spec.metric_data("march_roofline_pct.view")
    return layers.roofline_pct(ctx, "march_roofline_pct.view", data["kernels"], data["work"])
