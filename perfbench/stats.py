"""The window's arithmetic: a rate over the whole window and a tail over
every frame or step in it."""

from __future__ import annotations

import statistics
import time
from dataclasses import dataclass, field


@dataclass
class Window:
    """One measured window: its start and end on the host clock (s), and
    per frame or step the latency from issue to sync and the host time from
    issue to the return of the call."""

    start: float
    end: float = 0.0
    latencies: list[float] = field(default_factory=list)
    host: list[float] = field(default_factory=list)

    @property
    def count(self) -> int:
        return len(self.latencies)

    @property
    def seconds(self) -> float:
        return self.end - self.start

    def per_item_ms(self) -> float:
        """The whole window over all the items completed in it."""
        return self.seconds / self.count * 1e3

    def p95_ms(self) -> float:
        """The 95th percentile of every item's latency."""
        return percentile(self.latencies, 95) * 1e3

    def host_ms(self) -> float:
        return statistics.fmean(self.host) * 1e3


def percentile(values: list[float], q: int) -> float:
    """The q-th percentile of ``values`` (``statistics.quantiles``'
    exclusive method; one value is its own percentile)."""
    if len(values) == 1:
        return values[0]
    return statistics.quantiles(values, n=100)[q - 1]


def tenths_ms(latencies: list[float]) -> list[float]:
    """The mean latency (ms) of each tenth of the items, in order: how the
    work drifts over the window."""
    n = len(latencies)
    parts = [latencies[k * n // 10:(k + 1) * n // 10] for k in range(10)]
    return [round(statistics.fmean(p) * 1e3, 4) for p in parts if p]


def run_window(issue, sync, seconds: float, keep=None, clock=time.perf_counter, count: int | None = None) -> Window:
    """Issue items 0, 1, ... until ``seconds`` have passed, or, where
    ``count`` is given, exactly ``count`` items: ``issue(i)`` returns the
    item's output, ``sync(out)`` waits until it is done; no item is issued
    before the previous one is synchronised.  ``keep(i, out)``, when given,
    runs after the sync and outside the item's latency."""
    w = Window(start=clock())
    i = 0
    while True:
        t0 = clock()
        out = issue(i)
        t1 = clock()
        sync(out)
        t2 = clock()
        w.latencies.append(t2 - t0)
        w.host.append(t1 - t0)
        w.end = t2
        if keep is not None:
            keep(i, out)
        i += 1
        if (i >= count) if count is not None else (t2 - w.start >= seconds):
            return w
