"""Device: the share of the traced frames in which no operation ran on the card,
from the union of the device intervals."""

from perfbench import layers


def read(ctx):
    return layers.idle_pct(ctx)
