"""What the readers of the program's spans share: the ``volym.*`` ranges
that ``volym_tpu_torch.tracing`` records while the profiler runs, read
from a trace's host events by interval, per analysed item.

A span's children are the ``volym.*`` spans it holds; its self time is its
length less the union of its children.  Where the trace holds no span of
the names asked for (a program that records none), every reader returns
None and writes no note.
"""

from __future__ import annotations

from bisect import bisect_right

from perfbench import trace
from perfbench.layers import Context

PREFIX = "volym."
RENDER = "volym.render"
BACKWARD = "volym.backward"
#: the frame set-up's spans; their children lie inside their union
SETUP = ("volym.grids", "volym.ray_table", "volym.cone_table")
#: the autograd engine's span around each backward node it runs
ENGINE = "autograd::engine::evaluate_function"
#: the name of idle time at whose midpoint no ``volym.*`` span runs
OUTSIDE = "outside_program"


def intervals(tr: trace.Trace, names) -> list[tuple[float, float]]:
    """The merged host intervals of the spans named ``names``."""
    names = set(names)
    return trace.merge([(s, e) for n, s, e in tr.host if n in names])


def covered(merged: list[tuple[float, float]], t: float) -> bool:
    """Whether ``t`` lies in one of the merged, sorted ``intervals``."""
    k = bisect_right(merged, (t, float("inf"))) - 1
    return k >= 0 and merged[k][0] <= t <= merged[k][1]


def length(intervals_) -> float:
    return sum(e - s for s, e in intervals_)


def idle_gaps(busy: list[tuple[float, float]], lo: float, hi: float) -> list[tuple[float, float]]:
    """The stretches of [lo, hi] outside the merged intervals ``busy``."""
    gaps, t = [], lo
    for s, e in trace.clip(busy, lo, hi):
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if hi > t:
        gaps.append((t, hi))
    return gaps


def host_ms(ctx: Context, names) -> float | None:
    """The mean host ms per item in the union of the spans named ``names``,
    clipped to the item; None where the trace holds none of them."""
    if ctx.trace is None or not ctx.items:
        return None
    merged = intervals(ctx.trace, names)
    if not merged:
        return None
    return sum(length(trace.clip(merged, lo, hi)) for lo, hi in ctx.items) / len(ctx.items) / 1e3


def program_spans(ctx: Context) -> list[list[tuple[str, float, float]]]:
    """Per analysed item, the ``volym.*`` spans that overlap it, clipped to it."""
    spans = [h for h in ctx.trace.host if h[0].startswith(PREFIX)]
    return [[(n, max(s, lo), min(e, hi)) for n, s, e in spans if e > lo and s < hi] for lo, hi in ctx.items]


def span_host_ms(ctx: Context) -> dict[str, dict[str, float]]:
    """Per ``volym.*`` span name, its mean host ms per item: ``total`` (the
    union of its ranges) and ``self`` (less the union of its children)."""
    totals: dict[str, float] = {}
    selves: dict[str, float] = {}
    for spans in program_spans(ctx):
        by_name: dict[str, list] = {}
        for i, (name, s, e) in enumerate(spans):
            by_name.setdefault(name, []).append((s, e))
            children = [(cs, ce) for j, (_, cs, ce) in enumerate(spans) if j != i and s <= cs and ce <= e]
            selves[name] = selves.get(name, 0.0) + (e - s) - length(trace.merge(children))
        for name, iv in by_name.items():
            totals[name] = totals.get(name, 0.0) + length(trace.merge(iv))
    n = len(ctx.items)
    return {name: {"total": totals[name] / n / 1e3, "self": selves[name] / n / 1e3} for name in sorted(totals)}


def setup_idle(ctx: Context) -> tuple[float, dict[str, float], float]:
    """-> (the mean device idle ms per item whose gaps' midpoints lie in a
    set-up span, the idle ms per item by the innermost ``volym.*`` span at
    each gap's midpoint (``OUTSIDE`` where none runs), the mean idle ms per
    item)."""
    setup = intervals(ctx.trace, SETUP)
    busy = trace.merge([(s, e) for _, s, e in ctx.trace.device])
    in_setup, idle = 0.0, 0.0
    by_span: dict[str, float] = {}
    for (lo, hi), spans in zip(ctx.items, program_spans(ctx)):
        for s, e in idle_gaps(busy, lo, hi):
            mid = 0.5 * (s + e)
            idle += e - s
            if covered(setup, mid):
                in_setup += e - s
            holders = [sp for sp in spans if sp[1] <= mid <= sp[2]]
            inner = min(holders, key=lambda sp: sp[2] - sp[1], default=None)
            key = inner[0] if inner else OUTSIDE
            by_span[key] = by_span.get(key, 0.0) + (e - s)
    n = len(ctx.items)
    return in_setup / n / 1e3, {k: v / n / 1e3 for k, v in sorted(by_span.items())}, idle / n / 1e3


def setup_launches(ctx: Context, patterns: list[str]) -> float | None:
    """The mean count per item of host calls matching ``patterns`` (the
    CUDA runtime's launches, copies and sets) whose start lies in a set-up
    span; None where the trace holds no set-up span."""
    if ctx.trace is None or not ctx.items:
        return None
    setup = intervals(ctx.trace, SETUP)
    if not setup:
        return None
    count = 0
    for name, s, _ in ctx.trace.host:
        if covered(setup, s) and covered(ctx.items, s) and trace.matches(name, patterns):
            count += 1
    return count / len(ctx.items)


def engine_outside_backward(ctx: Context, top: int = 8) -> dict:
    """The autograd engine's nodes outside ``volym.backward`` (the set-up's
    own backward, the loss's): mean host ms per item in all (``total``) and
    by node, the ``top`` largest."""
    backward = intervals(ctx.trace, [BACKWARD])
    by_node: dict[str, list] = {}
    for name, s, e in ctx.trace.host:
        if name.startswith(ENGINE):
            by_node.setdefault(name[len(ENGINE):].lstrip(": ") or name, []).append((s, e))
    n = len(ctx.items)

    def outside(iv) -> float:
        us = 0.0
        for lo, hi in ctx.items:
            mine = trace.merge(trace.clip(iv, lo, hi))
            us += length(mine) - sum(length(trace.clip(mine, s, e)) for s, e in trace.clip(backward, lo, hi))
        return us / n / 1e3

    nodes = {k: outside(v) for k, v in by_node.items()}
    total = outside([iv for v in by_node.values() for iv in v])
    return {"total": total, "by_node": dict(sorted(nodes.items(), key=lambda kv: -kv[1])[:top])}
