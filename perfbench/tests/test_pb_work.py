"""The work counts, the bound and the readers' arithmetic on a made-up trace."""

import pytest
import torch

from perfbench import inputs, layers, reference, spec, stats, trace, work


def test_bound_takes_the_larger_time_and_names_it():
    assert work.bound(3.35e12, 0.0) == (1.0, "bytes")
    assert work.bound(0.0, 67e12 * 2) == (2.0, "operations")


def test_step_counts_on_a_tiny_scene_equal_a_count_by_hand(root):
    """The reference's live and composited steps equal a brute count over
    its own per-step masks, and a frame with the camera outside the box
    has live steps only where rays cross it."""
    cell = spec.load_cell("orbit_view.teapot256_cone", root)
    vol, imp, _ = inputs.make_volume(dict(cell.config["volume"], side=16), 3, "cpu")
    lut = torch.as_tensor(inputs.default_lut())
    p = reference.Params.from_config(cell.config["params"])
    m = inputs.orbit_matrices(30.0, 10.0, cell.config["camera"], 4 / 3)
    img, counts = reference.render(vol, imp, lut, m, p, 12, 16)
    g = reference.grids(vol, imp, p, m["view"])
    f = reference.ray_table(reference.cam_tensors(m, "cpu"), reference.pixel_ndc(12, 16, "cpu"), g, g.vol.shape[1])
    st = reference.steps(f, g.planes, 16, 16, g.sign, p.subtexel_bits)
    in_window = (f[reference.F_SIGNOK] > 0.5) & (st.t >= f[reference.F_ENTRY]) & (st.t < f[reference.F_EXIT])
    assert counts["valid_steps"] == int(in_window.sum())
    assert 0 < counts["composited_steps"] <= counts["live_steps"] <= counts["valid_steps"]
    assert counts["probed_steps"] <= counts["valid_steps"]


def test_work_functions_scale_with_the_counts():
    cfg = {"height": 2, "width": 3, "volume": {"side": 4},
           "params": {"use_gaussian_smoothing": True, "use_shading": True, "use_cone_importance_check": True}}
    c1 = {"live_steps": 10, "composited_steps": 4, "valid_steps": 12, "probed_steps": 5}
    c2 = {k: 2 * v for k, v in c1.items()}
    for kind, fn in work.WORK.items():
        b1, o1 = fn(cfg, 8, c1)
        b2, o2 = fn(cfg, 8, c2)
        assert o2 == 2 * o1 and b2 == b1 and o1 > 0 and b1 > 0, kind
    assert work.march(cfg, 8, c1)[0] == 8 * 16 * 4 + 2 * 3 * 16
    assert work.march(cfg, 8, c1)[1] == 10 * (work.MARCH_LIVE_OPS + work.SMOOTH_LIVE_OPS) + 4 * (
        work.MARCH_COMPOSITED_OPS + work.SHADE_COMPOSITED_OPS)


def _ctx(cfg):
    """Two items of 1 ms; in each a 100 us march kernel and a 300 us torch
    op; the first item's work counted."""
    device = [("void anon::slab_march_kernel<true>(float*)", 100.0, 200.0),
              ("void at::native::vectorized_elementwise_kernel<4, at::native::CUDAFunctor_add<float> >()", 300.0, 600.0),
              ("void anon::slab_march_kernel<true>(float*)", 1100.0, 1200.0),
              ("void at::native::vectorized_elementwise_kernel<4, at::native::CUDAFunctor_add<float> >()", 1300.0, 1600.0)]
    host = [(trace.ITEM_SPAN, 0.0, 1000.0), (trace.ITEM_SPAN, 1000.0, 2000.0), ("aten::add", 650.0, 900.0)]
    win = stats.Window(start=0.0, end=1.0, latencies=[0.5, 0.5], host=[0.25, 0.25])
    return layers.Context(cfg=cfg, planes=8, window=win, trace=trace.Trace(device, host),
                          items=trace.item_spans(trace.Trace(device, host)),
                          work={0: {"live_steps": 1e9, "composited_steps": 0}})


def test_readers_on_a_made_up_trace(root):
    cfg = {"height": 1, "width": 1, "volume": {"side": 1},
           "params": {"use_gaussian_smoothing": False, "use_shading": False}}
    ctx = _ctx(cfg)
    assert layers.mean_ms(ctx, ["slab_march_kernel"]) == pytest.approx(0.1)
    assert layers.mean_ms(ctx, None, exclude=spec.metric_data("torch_ops_ms.view")["port_kernels"]) == pytest.approx(0.3)
    assert layers.idle_pct(ctx) == pytest.approx(60.0)
    least = 1e9 * work.MARCH_LIVE_OPS / work.F32_OPS_PER_S
    assert layers.roofline_pct(ctx, "m", ["slab_march_kernel"], "march") == pytest.approx(100 * least / 100e-6)
    assert ctx.notes["m"]["bound_by"] == "operations"
    assert layers.mfu_pct(ctx, ["march", "gate"]) == pytest.approx(100 * least / 1e-3)
    assert layers.roofline_pct(ctx, "g", ["lookahead_kernel"], "gate") is None  # nothing to read: no number
    gaps = dict(trace.idle_gaps(ctx.trace, 0.0, 2000.0))
    assert gaps == pytest.approx({"perfbench.item": 700e-6, "aten::add": 500e-6})
    assert trace.top_device_ops(ctx.trace, 0.0, 2000.0)[0] == ["at::native::vectorized_elementwise_kernel[CUDAFunctor_add]", 6e-4]
    assert spec.load_reader("host_ms.view")(ctx) == pytest.approx(250.0)


def test_device_copies_of_host_annotations_are_not_device_time():
    class E:
        def __init__(self, name, dev, s, d):
            self.n, self.dev, self.s, self.d = name, dev, s, d

        def name(self):
            return self.n

        def device_type(self):
            return self.dev

        def start_ns(self):
            return self.s

        def duration_ns(self):
            return self.d

    class P:
        class profiler:
            class kineto_results:
                @staticmethod
                def events():
                    return [E("Optimizer.step#Adam.step", "DeviceType.CPU", 0, 5000),
                            E("Optimizer.step#Adam.step", "DeviceType.CUDA", 0, 5000),
                            E("void k()", "DeviceType.CUDA", 1000, 1000)]

    tr = trace.from_profiler(P)
    assert [n for n, _, _ in tr.device] == ["void k()"]
    assert trace.busy_us(tr, 0.0, 5.0) == pytest.approx(1.0)
