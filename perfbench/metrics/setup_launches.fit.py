"""Frame set-up and autograd: the CUDA runtime's launch, copy and set calls per
step that start inside a set-up span; the calls' name patterns are in
``setup_launches.fit.json``."""

from perfbench import spans, spec


def read(ctx):
    return spans.setup_launches(ctx, spec.metric_data("setup_launches.fit")["runtime_calls"])
