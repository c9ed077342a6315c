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
    ranks: int = 1  # the processes, one a card, whose collectives the items run
    peers: list = field(default_factory=list)  # ranks 1.., each (its traced device operations, its items)


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


def exposed_ms(ctx: Context, patterns: list[str]) -> float | None:
    """The mean device ms per item in which an operation matching
    ``patterns`` runs and no other operation does (the union of the first
    less the union of the rest); None where none of them ran."""
    if ctx.trace is None or not ctx.items:
        return None
    out, seen = [], False
    for lo, hi in ctx.items:
        ops = [(n, s, e) for n, s, e in ctx.trace.device if e > lo and s < hi]
        mine = trace.merge(trace.clip([(s, e) for n, s, e in ops if trace.matches(n, patterns)], lo, hi))
        seen = seen or bool(mine)
        rest = trace.merge(trace.clip([(s, e) for n, s, e in ops if not trace.matches(n, patterns)], lo, hi))
        out.append(sum(e - s for s, e in mine) - overlap_us(mine, rest))
    return sum(out) / len(out) / 1e3 if seen else None


def collective_us(device, items, patterns: list[str]) -> list[list[float]]:
    """Per item, the device us of each operation matching ``patterns`` that
    starts in it, in the order they start."""
    return [[e - s for n, s, e in sorted(device, key=lambda op: op[1]) if lo <= s < hi and trace.matches(n, patterns)]
            for lo, hi in items]


def transfer_ms(ctx: Context, patterns: list[str]) -> float | None:
    """The mean device ms per item that the collectives matching
    ``patterns`` take to move their data: each collective's shortest kernel
    over the ranks (the last rank to reach a collective waits for no other),
    summed over the item.  None without peers or such collectives, or where
    the ranks' traces do not hold the same collectives."""
    if ctx.trace is None or not ctx.items or not ctx.peers:
        return None
    ranks = [collective_us(ctx.trace.device, ctx.items, patterns)]
    ranks += [collective_us(device, items, patterns) for device, items in ctx.peers]
    shape = [len(k) for k in ranks[0]]
    if not any(shape) or any([len(k) for k in r] != shape for r in ranks):
        return None
    per_item = [sum(min(durations) for durations in zip(*(r[i] for r in ranks))) for i in range(len(shape))]
    return sum(per_item) / len(per_item) / 1e3


def overlap_us(a: list[tuple[float, float]], b: list[tuple[float, float]]) -> float:
    """The length of the intersection of two merged, sorted interval lists."""
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        total += max(0.0, hi - lo)
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total
