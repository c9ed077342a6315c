"""The reduction of a ``torch.profiler`` trace to what the per-layer metrics
read: device intervals by kernel name, the device's busy time as the union
of its intervals, each frame's or step's kernels, and the idle gaps named
by what the host was doing in them.

Events are plain tuples ``(name, start_us, end_us)``, taken in memory from
the profiler (nothing is written to disk), so the reduction runs on the
CPU from made-up events too.
"""

from __future__ import annotations

import re
from dataclasses import dataclass

#: the benchmark's own spans around each frame or step (``record_function``)
ITEM_SPAN = "perfbench.item"


@dataclass
class Trace:
    device: list[tuple[str, float, float]]  # kernels, copies and sets on the device
    host: list[tuple[str, float, float]]  # host operations and the benchmark's spans


def from_profiler(prof) -> Trace:
    """The device and host events of a finished ``torch.profiler.profile``."""
    device, host = [], []
    for e in prof.profiler.kineto_results.events():
        if hasattr(e, "start_ns"):
            start, end = e.start_ns() / 1e3, (e.start_ns() + e.duration_ns()) / 1e3
        else:
            start, end = float(e.start_us()), float(e.start_us() + e.duration_us())
        row = (e.name(), start, end)
        (host if str(e.device_type()).endswith("CPU") else device).append(row)
    # the device timeline also carries a copy of each host annotation's
    # range (``record_function``, the optimizer's step): no operation ran
    names = {n for n, _, _ in host}
    device = [r for r in device if r[0] not in names]
    device.sort(key=lambda r: r[1])
    host.sort(key=lambda r: r[1])
    return Trace(device, host)


def item_spans(trace: Trace) -> list[tuple[float, float]]:
    """The (start, end) of each frame's or step's span, in order."""
    return [(s, e) for name, s, e in trace.host if name == ITEM_SPAN]


def merge(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def clip(intervals, lo: float, hi: float) -> list[tuple[float, float]]:
    return [(max(s, lo), min(e, hi)) for s, e in intervals if e > lo and s < hi]


def busy_us(trace: Trace, lo: float, hi: float) -> float:
    """Microseconds of [lo, hi] in which some device operation ran."""
    return sum(e - s for s, e in merge(clip([(s, e) for _, s, e in trace.device], lo, hi)))


def kernels_in(trace: Trace, lo: float, hi: float) -> list[tuple[str, float]]:
    """(name, device us) of each device operation that starts in [lo, hi]."""
    return [(n, e - s) for n, s, e in trace.device if lo <= s < hi]


def short_name(name: str) -> str:
    """A kernel's name without its template arguments and parameter list;
    for PyTorch's elementwise, reduction and gather kernels, with the
    operation that instantiated them in brackets."""
    name = re.sub(r"^void\s+", "", name).replace("(anonymous namespace)", "anon")
    depth, out = 0, []
    for ch in name:
        if ch in "<(":
            if depth == 0 and ch == "(":
                break
            depth += 1
        elif ch in ">)":
            depth -= 1
        elif depth == 0:
            out.append(ch)
    family = "".join(out).strip() or name[:80]
    op = re.search(r"(\w+_kernel(?:_impl|_cuda)?|\w*Functor_\w+|\w+Op\b)", name[len(family):])
    return f"{family}[{op.group(1)}]" if op and op.group(1) not in family else family


def top_device_ops(trace: Trace, lo: float, hi: float, count: int = 10) -> list[list]:
    """The device operations that took most time in [lo, hi]: [name, s]."""
    totals: dict[str, float] = {}
    for n, us in kernels_in(trace, lo, hi):
        k = short_name(n)
        totals[k] = totals.get(k, 0.0) + us
    return [[k, v / 1e6] for k, v in sorted(totals.items(), key=lambda kv: -kv[1])[:count]]


def idle_gaps(trace: Trace, lo: float, hi: float, count: int = 10) -> list[list]:
    """The device's idle time in [lo, hi], summed by the innermost host
    operation running at each gap's midpoint ("host: python" where none
    is): [name, s], the largest first."""
    busy = merge(clip([(s, e) for _, s, e in trace.device], lo, hi))
    gaps, t = [], lo
    for s, e in busy:
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if hi > t:
        gaps.append((t, hi))
    totals: dict[str, float] = {}
    host, p, active = sorted(trace.host, key=lambda r: r[1]), 0, []
    for s, e in gaps:  # in time order: sweep the host events once
        mid = 0.5 * (s + e)
        while p < len(host) and host[p][1] <= mid:
            active.append(host[p])
            p += 1
        active = [h for h in active if h[2] >= mid]
        inner = min(active, key=lambda h: h[2] - h[1], default=None)
        key = inner[0] if inner else "host: python"
        totals[key] = totals.get(key, 0.0) + (e - s)
    return [[k, v / 1e6] for k, v in sorted(totals.items(), key=lambda kv: -kv[1])[:count]]


def matches(name: str, patterns: list[str]) -> bool:
    return any(re.search(p, name) for p in patterns)
