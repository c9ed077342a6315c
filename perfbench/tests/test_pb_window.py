"""The window's arithmetic: a rate over the whole window, a tail over every item."""

import statistics

import pytest

from perfbench import stats


class Clock:
    """A host clock that advances by each item's planted cost."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _window(costs, seconds):
    clock = Clock()

    def issue(i):
        clock.t += 0.001  # host work before the call returns
        return i

    def sync(i):
        clock.t += costs[i % len(costs)] - 0.001

    return stats.run_window(issue, sync, seconds, clock=clock)


def test_rate_is_the_whole_window_over_every_item():
    w = _window([0.010], 1.0)
    assert w.count == 100
    assert w.per_item_ms() == pytest.approx(10.0)
    assert w.host_ms() == pytest.approx(1.0)
    assert w.p95_ms() == pytest.approx(10.0)


def test_a_planted_stall_moves_the_rate_and_the_tail():
    calm = _window([0.010], 1.0)
    costs = [0.010] * 19 + [0.110]  # one item in 20 stalls by 100 ms
    stalled = _window(costs, 1.0)
    assert stalled.per_item_ms() > calm.per_item_ms() * 1.3
    assert stalled.p95_ms() > calm.p95_ms() * 2
    # the tail is of every item, not a median of chunks
    assert stalled.p95_ms() == pytest.approx(stats.percentile(stalled.latencies, 95) * 1e3)
    assert statistics.median(stalled.latencies) == pytest.approx(0.010)


def test_the_window_ends_with_the_item_that_crosses_its_length():
    w = _window([0.3], 1.0)
    assert w.count == 4 and w.seconds == pytest.approx(1.2)

