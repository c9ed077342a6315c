"""The port's spans (``volym_tpu_torch.tracing``) on the CPU: where they sit
and how they nest under ``torch.profiler``, and that with no profiler
active no ``record_function`` is entered.

Frames of 8x8 rays on an 8^3 teapot, through the slab path's dispatchers
(``slab_march.march``, ``lookahead.gate``, ``slab_replay.replay``,
``voxel_grad.smooth_scatter``), which send CPU tensors to the plain versions.
"""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from volym_tpu_torch import Camera, RenderParams, Scene, tracing
from volym_tpu_torch.ops import feats_grad, lookahead, slab_march, slab_replay, voxel_grad
from volym_tpu_torch.render import renderer

SIDE, H, W = 8, 8, 8
CONE = RenderParams(use_gaussian_smoothing=False, use_importance_rendering=True, use_cone_importance_check=True)
SMOOTHED = RenderParams(use_gaussian_smoothing=True, camera_grads=False, raymarching_step_size=1.0 / SIDE)


@pytest.fixture
def dispatching(monkeypatch):
    """``make_renderer``'s slab path wired to the dispatchers, as with
    ``backend="slab_cuda"``, on the CPU."""
    monkeypatch.setattr(renderer, "slab_functions", lambda backend, devices: (
        slab_march.march, slab_replay.replay, voxel_grad.smooth_scatter, feats_grad.feats_grad, lookahead.gate))


def _parents(prof) -> dict[str, set]:
    """Each ``volym.*`` span's name -> the names of the innermost ``volym.*``
    spans that hold it on its thread (None at the top)."""
    spans = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns(), e.start_thread_id())
             for e in prof.profiler.kineto_results.events()
             if e.name().startswith("volym.") and str(e.device_type()).endswith("CPU")]
    out: dict[str, set] = {}
    for i, (name, start, end, thread) in enumerate(spans):
        holders = [o for j, o in enumerate(spans) if j != i and o[3] == thread and o[1] <= start and end <= o[2]]
        inner = min(holders, key=lambda o: o[2] - o[1], default=None)
        out.setdefault(name, set()).add(inner[0] if inner else None)
    return out


def _teapot(grad: bool = False) -> Scene:
    s = Scene.synthetic("teapot", side=SIDE)
    if grad:
        s = Scene(s.volume.clone().requires_grad_(True), s.importance, s.tf_lut.clone().requires_grad_(True))
    return s


def test_cone_frame_spans_nest_as_the_layers(dispatching):
    render = renderer.make_renderer(_teapot(), CONE, H, W, backend="slab_cuda", device="cpu")
    cam = Camera().orbit(30.0, 20.0, 0.0).matrices()
    untraced = render(cam)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        traced = render(cam)
    assert torch.equal(traced, untraced)  # spans change no computation
    assert _parents(prof) == {
        "volym.render": {None},
        "volym.grids": {"volym.render"},
        "volym.layout": {"volym.grids"},
        "volym.gradient_field": {"volym.grids"},
        "volym.importance_levels": {"volym.grids"},
        "volym.ray_table": {"volym.render"},
        "volym.cone_table": {"volym.render"},
        "volym.gate": {"volym.render"},
        "volym.march": {"volym.render"},
    }


def test_smoothed_backward_holds_the_replay_and_the_fold():
    scene = _teapot(grad=True)
    cam = Camera().orbit(30.0, 20.0, 0.0).matrices()
    img = slab_march.render_diff(scene, cam, SMOOTHED, H, W)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        img.sum().backward()
    parents = _parents(prof)
    assert parents["volym.replay"] == {"volym.backward"}
    assert parents["volym.fold"] == {"volym.backward"}
    assert parents["volym.backward"] == {None}
    assert float(scene.volume.grad.abs().max()) > 0


def test_no_record_function_without_a_profiler(monkeypatch, dispatching):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered with no profiler active")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    cam = Camera().orbit(30.0, 20.0, 0.0).matrices()
    renderer.make_renderer(_teapot(), CONE, H, W, backend="slab_cuda", device="cpu")(cam)
    scene = _teapot(grad=True)
    slab_march.render_diff(scene, cam, SMOOTHED, H, W).sum().backward()
    assert scene.volume.grad is not None
    with profile(activities=[ProfilerActivity.CPU]), pytest.raises(AssertionError, match="volym.x"):
        tracing.span("volym.x")  # the patched function is the one a span enters


def test_the_gate_follows_the_profiler_in_and_out():
    assert torch.autograd.profiler._is_profiler_enabled is False
    assert tracing.span("volym.x") is tracing.span("volym.y")
    with profile(activities=[ProfilerActivity.CPU]):
        assert torch.autograd.profiler._is_profiler_enabled is True
        assert isinstance(tracing.span("volym.x"), torch.profiler.record_function)
    assert torch.autograd.profiler._is_profiler_enabled is False
    assert tracing.span("volym.x") is tracing.span("volym.y")
