"""What the per-layer readers share: the traced items' device time by
kernel pattern, and a kernel's share of its roofline."""

from __future__ import annotations

from dataclasses import dataclass, field

from perfbench import trace, work
from perfbench.stats import Window


@dataclass
class Context:
    """What a ``--trace 1`` run hands each reader of ``metrics/``."""

    cfg: dict
    planes: int
    window: Window  # the run's untraced window (host clocks)
    trace: trace.Trace | None  # the traced segment; None without a device trace
    items: list[tuple[float, float]]  # the analysed items' spans in the trace (us)
    work: dict[int, dict] = field(default_factory=dict)  # analysed item -> the reference's step counts
    peak_window_bytes: int = 0
    notes: dict = field(default_factory=dict)  # what a reader reports beside its number


def item_kernel_us(ctx: Context, patterns: list[str] | None, exclude: list[str] | None = None) -> list[float]:
    """Per analysed item, the device us of the operations matching
    ``patterns`` (every one when None) and none of ``exclude``."""
    out = []
    for lo, hi in ctx.items:
        us = 0.0
        for name, dt in trace.kernels_in(ctx.trace, lo, hi):
            if patterns is not None and not trace.matches(name, patterns):
                continue
            if exclude and trace.matches(name, exclude):
                continue
            us += dt
        out.append(us)
    return out


def mean_ms(ctx: Context, patterns, exclude=None) -> float | None:
    """The mean device ms per item of the matching operations; None where
    the trace holds none of them."""
    if ctx.trace is None or not ctx.items:
        return None
    us = item_kernel_us(ctx, patterns, exclude)
    if not any(us):
        return None
    return sum(us) / len(us) / 1e3


def roofline_pct(ctx: Context, name: str, patterns: list[str], kind: str) -> float | None:
    """The kernels' share of their roofline over the items whose work the
    reference counted: the least time for that work (``work.WORK[kind]``)
    over the kernels' device time.  None where they did not run."""
    if ctx.trace is None or not ctx.work:
        return None
    us = item_kernel_us(ctx, patterns)
    spent = sum(us[i] for i in ctx.work) / 1e6
    if spent <= 0.0:
        return None
    least, by = 0.0, {}
    for counts in ctx.work.values():
        n_bytes, n_ops = work.WORK[kind](ctx.cfg, ctx.planes, counts)
        t, which = work.bound(n_bytes, n_ops)
        least += t
        by[which] = by.get(which, 0) + 1
    ctx.notes[name] = {"bound_by": max(by, key=by.get), "least_s": least, "device_s": spent}
    return 100.0 * least / spent


def idle_pct(ctx: Context) -> float | None:
    if ctx.trace is None or not ctx.items:
        return None
    lo, hi = ctx.items[0][0], ctx.items[-1][1]
    busy = trace.busy_us(ctx.trace, lo, hi)
    if busy <= 0.0:
        return None
    return 100.0 * (1.0 - busy / (hi - lo))


def mfu_pct(ctx: Context, kinds: list[str]) -> float | None:
    """The counted items' operations (``work.WORK[kind]`` of each kind
    whose steps the reference counted) over their wall time at the float32
    peak."""
    if ctx.trace is None or not ctx.work:
        return None
    ops = 0.0
    for counts in ctx.work.values():
        for kind in kinds:
            try:
                ops += work.WORK[kind](ctx.cfg, ctx.planes, counts)[1]
            except KeyError:  # a layer this cell does not run (no look-ahead counts)
                continue
    wall = sum(ctx.items[i][1] - ctx.items[i][0] for i in ctx.work) / 1e6
    return 100.0 * ops / (wall * work.F32_OPS_PER_S)
