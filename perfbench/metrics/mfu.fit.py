"""Device: the whole step's share of the card's float32 peak: the operations that
the counted layers' work functions give for the steps the reference counted,
over their wall time on the card at 67 TFLOP/s."""

from perfbench import layers, spec


def read(ctx):
    return layers.mfu_pct(ctx, spec.metric_data("mfu.fit")["work"])
