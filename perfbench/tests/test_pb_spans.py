"""The readers of the program's spans on a made-up trace: nested spans counted
once, idle gaps inside and outside a set-up span, launches counted by start
time, the idle split by span summing to the item's idle time, and no number
where the program records no span."""

import pytest

from perfbench import layers, spec, trace

#: one frame's events, us from its start: the set-up spans, the march and
#: the runtime calls (host); the device's busy stretches
FRAME_HOST = [
    ("perfbench.item", 0, 100), ("volym.render", 5, 80), ("volym.grids", 10, 40), ("volym.layout", 12, 15),
    ("cudaMemcpyAsync", 13, 14), ("volym.gradient_field", 20, 35), ("cudaLaunchKernel", 22, 23),
    ("aten::mul", 23, 24), ("cudaLaunchKernel", 39, 41), ("cudaLaunchKernel", 44, 46), ("volym.ray_table", 45, 55),
    ("cudaLaunchKernelExC", 50, 51), ("volym.march", 60, 75), ("cudaLaunchKernel", 62, 63),
]
FRAME_DEVICE = [("k", 0, 10), ("k", 25, 44), ("k", 56, 60), ("k", 66, 90)]
#: one fitting step's backward: the engine's nodes around and beside ``volym.backward``
STEP_HOST = [
    ("perfbench.item", 0, 100), ("autograd::engine::evaluate_function: DiffMarchBackward", 38, 72),
    ("volym.backward", 40, 70), ("volym.replay", 45, 55), ("volym.fold", 56, 66),
    ("autograd::engine::evaluate_function: IndexBackward0", 75, 85),
]


def _ctx(host, device, items=2, extra=()):
    """``items`` copies of the events 200 us apart, each an analysed item;
    ``extra`` events outside every item."""
    h = [(n, s + 200 * k, e + 200 * k) for k in range(items) for n, s, e in host] + list(extra)
    d = [(n, s + 200 * k, e + 200 * k) for k in range(items) for n, s, e in device]
    tr = trace.Trace(sorted(d, key=lambda r: r[1]), sorted(h, key=lambda r: r[1]))
    return layers.Context(cfg={}, planes=0, window=None, trace=tr, items=trace.item_spans(tr)[:items])


def _read(name, ctx):
    return spec.load_reader(name)(ctx)


@pytest.mark.parametrize("kind", ["view", "fit"])
def test_nested_spans_count_once(kind):
    ctx = _ctx(FRAME_HOST, FRAME_DEVICE)
    assert _read(f"render_host_ms.{kind}", ctx) == pytest.approx(0.075)
    # grids (30 us, its two children inside) and the ray table (10 us)
    assert _read(f"setup_host_ms.{kind}", ctx) == pytest.approx(0.040)
    by = ctx.notes["span_host_ms"]
    assert by["volym.render"] == pytest.approx({"total": 0.075, "self": 0.020})
    assert by["volym.grids"] == pytest.approx({"total": 0.030, "self": 0.012})
    assert by["volym.layout"] == pytest.approx({"total": 0.003, "self": 0.003})


@pytest.mark.parametrize("kind", ["view", "fit"])
def test_launches_count_by_their_start_inside_a_setup_span(kind):
    # outside every analysed item: a set-up span and its launch are not counted
    ctx = _ctx(FRAME_HOST, FRAME_DEVICE, extra=[("volym.grids", 402, 410), ("cudaLaunchKernel", 405, 406)])
    # at 13 (in layout, in grids), 22, 39 (ends past grids) and 50; not 44 (starts
    # before the ray table), 62 (in the march) nor aten::mul
    assert _read(f"setup_launches.{kind}", ctx) == pytest.approx(4.0)


@pytest.mark.parametrize("kind", ["view", "fit"])
def test_idle_inside_and_outside_the_setup(kind):
    ctx = _ctx(FRAME_HOST, FRAME_DEVICE)
    # gaps 10-25 (grids), 44-56 (ray table), 60-66 (march), 90-100 (no span)
    assert _read(f"setup_idle_ms.{kind}", ctx) == pytest.approx(0.027)
    by = ctx.notes["idle_by_span"]
    assert by == pytest.approx({"volym.grids": 0.015, "volym.ray_table": 0.012, "volym.march": 0.006,
                                "outside_program": 0.010})
    assert sum(by.values()) == pytest.approx(ctx.notes["item_idle_ms"]) == pytest.approx(0.043)
    assert _read(f"setup_idle_ms.{kind}", ctx) <= ctx.notes["item_idle_ms"]


def test_backward_and_the_engine_outside_it():
    ctx = _ctx(STEP_HOST, [("k", 0, 100)])
    assert _read("backward_host_ms.fit", ctx) == pytest.approx(0.030)
    outside = ctx.notes["engine_outside_backward_ms"]
    assert outside["total"] == pytest.approx(0.014)
    assert outside["by_node"] == pytest.approx({"IndexBackward0": 0.010, "DiffMarchBackward": 0.004})


@pytest.mark.parametrize("name", ["render_host_ms.view", "render_host_ms.fit", "setup_host_ms.view",
                                  "setup_host_ms.fit", "setup_launches.view", "setup_launches.fit",
                                  "setup_idle_ms.view", "setup_idle_ms.fit", "backward_host_ms.fit"])
def test_no_number_without_the_programs_spans(name):
    """A program that records no span (one older than the spans), and a run
    without a device trace, give no number and no note."""
    bare = [(n, s, e) for n, s, e in FRAME_HOST + STEP_HOST[1:] if not n.startswith("volym.")]
    ctx = _ctx(bare, FRAME_DEVICE)
    assert _read(name, ctx) is None and ctx.notes == {}
    assert _read(name, layers.Context(cfg={}, planes=0, window=None, trace=None, items=[])) is None
