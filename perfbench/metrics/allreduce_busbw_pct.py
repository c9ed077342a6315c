"""Collectives: the step's bus bandwidth as a share of one card's NVLink 4 rate
one way (450 GB/s): the bytes the fit must sum (``work.allreduce_bytes``:
the volume's and the LUT's cotangents and the loss, never what else the
program sends) times 2 (n - 1) / n, over the time the step's all-reduces
take to move their data (``layers.transfer_ms``: each all-reduce's shortest
kernel over the ranks, so the wait for the slowest rank is left out).  Its
notes: ``allreduce_kernels`` names the kernels (NCCL's algorithm and
protocol are in the names), ``allreduce_transfer_ms`` the time, and
``allreduce_wait_ms`` the rest of rank 0's ``allreduce_ms``: the wait."""

from perfbench import layers, spec, trace, work


def read(ctx):
    patterns = spec.metric_data("allreduce_ms")["kernels"]
    ms = layers.transfer_ms(ctx, patterns)
    if ms is None or ctx.ranks < 2:
        return None
    ctx.notes["allreduce_kernels"] = sorted({trace.short_name(n) for n, _, _ in ctx.trace.device
                                             if trace.matches(n, patterns)})
    ctx.notes["allreduce_transfer_ms"] = ms
    ctx.notes["allreduce_wait_ms"] = layers.mean_ms(ctx, patterns) - ms
    n_bytes = work.bus_bytes(work.allreduce_bytes(ctx.cfg), ctx.ranks)
    return 100.0 * n_bytes / (ms / 1e3) / work.NVLINK_BYTES_PER_S
