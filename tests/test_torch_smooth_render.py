"""The forward render of volym_tpu_torch under Gaussian smoothing against
volym_tpu.

The same scene goes through the port's plain render on the CPU and through
the jnp golden and the emulated TPU forward
(``slab_kernel._render_pallas_jit`` under ``tests/pallas_emu.py``), the JAX
side run eagerly (``jax.disable_jit``), held by the repo rule
(``parity.check_close``), at 16^3 (trilinear taps engage there; nearest
ones are the identity below 50 planes, ``test_slab_kernel_ci.py:209-211``,
and ``test_torch_smooth_64`` holds a 64^3 nearest case): shaded and
unshaded, u8 and f32, native and resampled planes, and with the forward
look-ahead gate.  Then the default parameters through ``make_renderer`` and
the CLI.
"""

import jax
import numpy as np
import pytest
import torch

import volym_tpu as vj
from tests.pallas_emu import emulate
from volym_tpu.ops import slab_kernel
from volym_tpu.render import slab as jslab
from volym_tpu_torch import Camera, RenderParams, Scene, cli, convert, parity
from volym_tpu_torch.render import slab
from volym_tpu_torch.render.renderer import make_renderer

H, W = 16, 24

#: forward cases at 16^3: (interpolation, u8 stream, shading, step) with
#: native (1/16: 16 planes, u8) and resampled (2/16: 8 planes, f32) planes
FWD_CASES = [
    ("trilinear", True, False, 1.0 / 16), ("trilinear", True, True, 1.0 / 16),
    ("trilinear", False, False, 2.0 / 16), ("trilinear", False, True, 2.0 / 16),
    ("nearest", True, True, 1.0 / 16), ("nearest", False, True, 2.0 / 16),
]
ORBITS = [(30.0, 20.0), (210.0, 20.0), (120.0, 10.0), (300.0, -10.0), (20.0, 70.0), (20.0, -70.0)]


@pytest.fixture(scope="module")
def bonsai16():
    sj = vj.Scene.synthetic("bonsai", side=16, seed=5)
    return sj, convert.scene_from_jax(sj)


@pytest.mark.parametrize("interp,u8,shading,step", FWD_CASES)
@pytest.mark.parametrize("h,v", ORBITS[:4])
def test_smoothed_render_matches_golden(bonsai16, h, v, interp, u8, shading, step):
    sj, st = bonsai16
    pj = vj.RenderParams(use_gaussian_smoothing=True, interpolation=interp, use_shading=shading, u8_volume=u8,
                         raymarching_step_size=step, density_threshold=0.12)
    mj = vj.Camera(aspect=W / H, distance=1.2).orbit(h, v, 0.0).matrices()
    with jax.disable_jit():
        want = np.asarray(jslab.render(sj, mj, pj, H, W))
    pt = convert.render_params(pj)
    got = slab.render(st, convert.camera_matrices_from_jax(mj), pt, H, W)
    unsmoothed = slab.render(st, convert.camera_matrices_from_jax(mj), pt.replace(use_gaussian_smoothing=False), H, W)
    assert np.abs(want[..., 3]).max() > 0.5
    if interp == "trilinear":
        assert float((got - unsmoothed).abs().max()) > 1e-3, "smoothing changed nothing"
    parity.check_close(want, got, f"view {jslab.dominant_axis(mj)} {interp} u8={u8} shading={shading}")


@pytest.mark.parametrize("interp,u8,shading,step", FWD_CASES[:4])
@pytest.mark.parametrize("h,v", ORBITS[:2])
def test_smoothed_render_matches_tpu_kernel(bonsai16, h, v, interp, u8, shading, step):
    sj, st = bonsai16
    pj = vj.RenderParams(use_gaussian_smoothing=True, interpolation=interp, use_shading=shading, u8_volume=u8,
                         raymarching_step_size=step, density_threshold=0.12, camera_grads=False)
    mj = vj.Camera(aspect=W / H, distance=1.2).orbit(h, v, 0.0).matrices()
    major, sign = jslab.dominant_axis(mj)
    planes = jslab.resolve_planes(pj, 16)
    pk = pj if planes == 16 else pj.replace(u8_volume=False)
    with emulate(slab_kernel):
        want = np.asarray(slab_kernel._render_pallas_jit.__wrapped__(
            sj, mj, pk.pallas_static(), H, W, major, sign, knobs=pk.knobs(), planes=planes))
    got = slab.render(st, convert.camera_matrices_from_jax(mj), convert.render_params(pj), H, W)
    parity.check_close(want, got, f"view {(major, sign)} {interp} u8={u8} shading={shading}")


@pytest.mark.parametrize("cone", [False, True], ids=["straight", "cone"])
@pytest.mark.parametrize("h,v", ORBITS[:3])
def test_smoothed_lookahead_matches_golden(h, v, cone):
    """The forward look-ahead gate with smoothing, on the three-level scene
    of ``test_torch_lookahead``, against the jnp golden."""
    from tests.test_torch_lookahead import three_level_scene

    vol, imp, lut = three_level_scene()
    sj, st = vj.Scene(volume=vol, importance=imp, tf_lut=lut), convert.scene(vol, imp, lut)
    pj = vj.RenderParams(use_gaussian_smoothing=True, interpolation="trilinear", raymarching_step_size=1.0 / 16,
                         density_threshold=0.12, use_importance_rendering=True, use_cone_importance_check=cone)
    mj = vj.Camera(aspect=W / H, distance=1.3).orbit(h, v, 0.0).matrices()
    with jax.disable_jit():
        want = np.asarray(jslab.render(sj, mj, pj, H, W))
    mt, pt = convert.camera_matrices_from_jax(mj), convert.render_params(pj)
    got = slab.render(st, mt, pt, H, W)
    base = slab.render(st, mt, pt.replace(use_importance_rendering=False), H, W)
    assert float((got - base).abs().max()) > 0.05, "look-ahead not engaged"
    parity.check_close(want, got, f"view {jslab.dominant_axis(mj)} cone={cone}")


def test_default_params_render_on_cpu():
    """``RenderParams()`` smooths (nearest, shaded, step .01): a frame
    through ``make_renderer`` and the CLI's default flags."""
    scene = Scene.synthetic("bonsai", side=32)
    img = make_renderer(scene, RenderParams(), H, W, backend="slab", device="cpu")(
        Camera(aspect=W / H).orbit(30.0, 20.0, 0.0).matrices())
    assert tuple(img.shape) == (H, W, 4) and bool(torch.isfinite(img).all()) and float(img[..., 3].max()) > 0.5


def test_cli_default_screenshot_smooths(tmp_path):
    from tests.test_torch_entry import read_png

    out = tmp_path / "shot.png"
    rc = cli.main(["screenshot", "--side", "32", "--width", "32", "--height", "24", "--device", "cpu",
                   "--renderer", "slab", "--output", str(out)])
    assert rc == 0
    img = read_png(out)
    assert img.shape == (24, 32, 4) and img[..., :3].max() > 0
    assert cli._params(cli.build_parser().parse_args(["screenshot"])).use_gaussian_smoothing
