"""Look-ahead gate B7 (with its bounds pass) in a frame: its roofline's least time over its device time."""

from perfbench import layers, spec


def read(ctx):
    data = spec.metric_data("gate_roofline_pct")
    return layers.roofline_pct(ctx, "gate_roofline_pct", data["kernels"], data["work"])
