"""The port's look-ahead render against volym_tpu's jnp golden, and its
entry points.

``volym_tpu.render.slab.render`` with importance look-ahead runs eagerly
(``jax.disable_jit``) on the same numpy volume, importance and LUT as the
port's plain render (``volym_tpu_torch.render.slab.render``), at every
(major axis, sign) view x {straight, cone} x {nearest, trilinear} x
{native, resampled planes}, on the three-level scene of
``test_torch_lookahead``.  Tolerance: the repo's knife-edge rule
(``parity.check_close``).  The golden finds the next important crossing
with an associative scan and the probe range as ``m + d_range * rate``
with ``rate = 1 / dt``, where the port, like the TPU kernels, divides by
``ts``; the two round differently, so a gate bit on the range's edge may
flip and move its ray by one step, which the rule's knife-edge share (0.2%
of the entries) allows.  Measured: no entry of the 48 cases is past the
knife-edge threshold, and the largest error is 1.2e-7.  Each case also
asserts that look-ahead engages: the image differs from Base by more than
0.05.
"""

import jax
import numpy as np
import pytest
import torch

import volym_tpu as vj
from tests.test_torch_lookahead import ORBITS, H, SIDE, STEPS, W, three_level_scene
from tests.test_torch_entry import read_png
from volym_tpu.render import slab as jslab
from volym_tpu_torch import Camera, RenderParams, Scene, cli, convert, parity
from volym_tpu_torch.ops import slab_march
from volym_tpu_torch.render import slab
from volym_tpu_torch.render.renderer import make_renderer


@pytest.mark.parametrize("step", STEPS)
@pytest.mark.parametrize("interp", ["nearest", "trilinear"])
@pytest.mark.parametrize("cone", [False, True], ids=["straight", "cone"])
@pytest.mark.parametrize("h,v", ORBITS)
def test_lookahead_matches_golden(h, v, cone, interp, step):
    vol, imp, lut = three_level_scene()
    sj, st = vj.Scene(volume=vol, importance=imp, tf_lut=lut), convert.scene(vol, imp, lut)
    mj = vj.Camera(aspect=W / H, distance=1.3).orbit(h, v, 0.0).matrices()
    pj = vj.RenderParams(
        use_gaussian_smoothing=False, interpolation=interp, raymarching_step_size=step, density_threshold=0.12,
        use_importance_rendering=True, use_cone_importance_check=cone,
    )
    with jax.disable_jit():
        want = np.asarray(jslab.render(sj, mj, pj, H, W))
    mt, pt = convert.camera_matrices_from_jax(mj), convert.render_params(pj)
    got = slab.render(st, mt, pt, H, W)
    base = slab.render(st, mt, pt.replace(use_importance_rendering=False), H, W).numpy()
    assert np.abs(want - base).max() > 0.05, "look-ahead not engaged"
    parity.check_close(want, got.numpy(), f"view {jslab.dominant_axis(mj)} cone={cone} {interp} step {step}")


@pytest.mark.parametrize("cone", [False, True], ids=["straight", "cone"])
def test_zero_importance_is_base(cone):
    """With no important voxel the gate is empty and the image is Base's,
    bit for bit."""
    vol, _, lut = three_level_scene()
    st = convert.scene(vol, np.zeros_like(vol), lut)
    p = RenderParams(use_gaussian_smoothing=False, raymarching_step_size=1.0 / SIDE)
    cam = Camera(aspect=W / H, distance=1.3).orbit(30.0, 20.0, 0.0).matrices()
    feats, _, _, sign, _, _ = slab_march.prepare(st, cam, p, H, W)
    la = p.replace(use_importance_rendering=True, use_cone_importance_check=cone)
    cone_feats, levels = slab_march.lookahead_inputs(st, cam, la, H, W)
    assert not slab.lookahead_gate(feats, cone_feats, levels, sign, 8).any()
    assert torch.equal(slab.render(st, cam, la, H, W), slab.render(st, cam, p, H, W))


def test_make_renderer_lookahead_on_cpu():
    scene = Scene.synthetic("teapot", side=SIDE)
    cam = Camera(aspect=W / H).orbit(30.0, 20.0, 0.0).matrices()
    base = RenderParams(use_gaussian_smoothing=False)
    imgs = {}
    for name, p in (("base", base), ("straight", base.replace(use_importance_rendering=True)),
                    ("cone", base.replace(use_importance_rendering=True, use_cone_importance_check=True))):
        imgs[name] = make_renderer(scene, p, H, W, backend="slab", device="cpu")(cam)
        assert tuple(imgs[name].shape) == (H, W, 4) and bool(torch.isfinite(imgs[name]).all())
    assert float((imgs["straight"] - imgs["base"]).abs().max()) > 0.05
    assert float((imgs["cone"] - imgs["base"]).abs().max()) > 0.05


def test_cli_screenshot_lookahead(tmp_path):
    out = tmp_path / "shot.png"
    rc = cli.main(["screenshot", "--importance", "--cone", "--scene", "teapot", "--no-gaussian", "--side", "16",
                   "--width", "32", "--height", "24", "--device", "cpu", "--renderer", "slab", "--output", str(out)])
    assert rc == 0
    img = read_png(out)
    assert img.shape == (24, 32, 4) and img[..., :3].max() > 0


def test_render_diff_lookahead_raises():
    """The gated backward runs: ``render_diff`` and ``make_renderer(...,
    differentiable=True)`` with look-ahead (straight and cone) give the
    gated forward render's image bit for bit and finite, nonzero volume and
    LUT gradients; the importance, which only builds the gate, gets none."""
    teapot = Scene.synthetic("teapot", side=8)
    cam = Camera().orbit(30.0, 20.0, 0.0).matrices()
    p = RenderParams(use_gaussian_smoothing=False, camera_grads=False, use_importance_rendering=True)
    for kw in ({}, dict(use_cone_importance_check=True)):
        pk = p.replace(**kw)
        want = slab.render(teapot, cam, pk, 8, 8)
        assert not torch.equal(want, slab.render(teapot, cam, p.replace(use_importance_rendering=False), 8, 8))
        s = Scene(teapot.volume.clone().requires_grad_(True), teapot.importance.clone().requires_grad_(True),
                  teapot.tf_lut.clone().requires_grad_(True))
        for img in (slab_march.render_diff(s, cam, pk, 8, 8),
                    make_renderer(s, pk, 8, 8, backend="slab", device="cpu", differentiable=True)(cam)):
            assert torch.equal(img.detach(), want)
            img.sum().backward()
        for t in (s.volume, s.tf_lut):
            assert bool(torch.isfinite(t.grad).all()) and float(t.grad.abs().max()) > 0, kw
        assert s.importance.grad is None
