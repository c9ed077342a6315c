"""The CUDA march, replay and look-ahead gate kernels against their plain
PyTorch versions, on the card.

Marked ``cuda``: these skip where ``torch.cuda.is_available()`` is false.
Run them on a GPU machine with
``python -m pytest tests/test_torch_cuda.py -q -m cuda``.
"""

import numpy as np
import pytest
import torch

from chip_smoke import three_level_scene
from volym_tpu_torch import Camera, RenderParams, Scene, convert, parity
from volym_tpu_torch.ops import lookahead, slab_march, slab_replay
from volym_tpu_torch.render import slab
from volym_tpu_torch.render.renderer import make_renderer

pytestmark = pytest.mark.cuda

SIDE, H, W = 32, 40, 56
ORBITS = [(30.0, 20.0), (210.0, 20.0), (120.0, 10.0), (300.0, -10.0), (20.0, 70.0), (20.0, -70.0)]


@pytest.fixture(scope="module")
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs CUDA: the march and replay kernels run only on an NVIDIA GPU")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def scene(device):
    return Scene.synthetic("bonsai", side=SIDE, seed=1, device=device)


@pytest.mark.parametrize("shading", [False, True])
@pytest.mark.parametrize("stream", ["u8", "f32"])
@pytest.mark.parametrize("interp", ["nearest", "trilinear"])
@pytest.mark.parametrize("h,v", ORBITS)
def test_kernel_matches_plain(scene, h, v, interp, stream, shading):
    p = RenderParams(
        use_gaussian_smoothing=False, interpolation=interp, use_shading=shading, u8_volume=True,
        raymarching_step_size=(1.0 if stream == "u8" else 2.0) / SIDE,
    )
    cam = Camera(aspect=W / H, distance=1.3).orbit(h, v, 0.0).matrices()
    feats, vol, lut, sign, grad, u8 = slab_march.prepare(scene, cam, p, H, W)
    assert u8 == (stream == "u8")
    got = slab_march.march_cuda(feats, vol, lut, sign, p, grad, u8=u8)
    want = slab.march_slabs(feats, vol, lut, sign, p, grad, u8=u8)
    torch.cuda.synchronize()
    assert np.isfinite(got.cpu().numpy()).all()
    parity.check_close(want, got, f"{interp} {stream} shading={shading}")
    # and against the plain version on the CPU, from the same table
    cpu = slab.march_slabs(
        feats.cpu(), vol.cpu(), lut.cpu(), sign, p, None if grad is None else grad.cpu(), u8=u8
    )
    parity.check_close(cpu, got.cpu(), f"{interp} {stream} shading={shading} vs CPU")


def test_renderer_counts_launches(scene, device):
    p = RenderParams(use_gaussian_smoothing=False)
    render = make_renderer(scene, p, H, W, backend="slab_cuda", device=device)
    before = slab_march.LAUNCHES
    img = render(Camera(aspect=W / H).orbit(10.0, 5.0, 0.0).matrices())
    assert slab_march.LAUNCHES == before + 1
    assert img.device.type == "cuda" and tuple(img.shape) == (H, W, 4)


def test_march_cuda_checks_inputs(scene):
    p = RenderParams(use_gaussian_smoothing=False, use_shading=False, raymarching_step_size=1.0 / SIDE)
    feats, vol, lut, sign, grad, u8 = slab_march.prepare(scene, Camera().matrices(), p, H, W)
    with pytest.raises(ValueError, match="dtype"):
        slab_march.march_cuda(feats, vol.float(), lut, sign, p, grad, u8=True)
    with pytest.raises(ValueError, match="contiguous"):
        slab_march.march_cuda(feats.transpose(1, 2), vol, lut, sign, p, grad, u8=u8)
    with pytest.raises(ValueError, match="on cpu"):
        slab_march.march_cuda(feats, vol, lut.cpu(), sign, p, grad, u8=u8)


def _diff_params(interp, stream, shading):
    return RenderParams(
        use_gaussian_smoothing=False, interpolation=interp, use_shading=shading, u8_volume=True,
        camera_grads=False, raymarching_step_size=(1.0 if stream == "u8" else 2.0) / SIDE,
    )


@pytest.mark.parametrize("shading", [False, True])
@pytest.mark.parametrize("stream", ["u8", "f32"])
@pytest.mark.parametrize("interp", ["nearest", "trilinear"])
@pytest.mark.parametrize("h,v", ORBITS)
def test_emit_density_matches_plain(scene, h, v, interp, stream, shading):
    """B1 with the residual: image and residual bit for bit against the
    plain march on the card, and the image unchanged by the residual."""
    p = _diff_params(interp, stream, shading)
    cam = Camera(aspect=W / H, distance=1.3).orbit(h, v, 0.0).matrices()
    feats, vol, lut, sign, grad, u8 = slab_march.prepare(scene, cam, p, H, W)
    img, dens = slab_march.march_cuda(feats, vol, lut, sign, p, grad, u8=u8, emit_density=True)
    plain_img, plain_dens = slab.march_slabs(feats, vol, lut, sign, p, grad, u8, emit_density=True)
    torch.cuda.synchronize()
    assert torch.equal(img, slab_march.march_cuda(feats, vol, lut, sign, p, grad, u8=u8))
    parity.check_close(plain_img, img, "image")
    assert torch.equal(plain_dens, dens), "residual differs from the plain march"


@pytest.mark.parametrize("shading", [False, True])
@pytest.mark.parametrize("stream", ["u8", "f32"])
@pytest.mark.parametrize("interp", ["nearest", "trilinear"])
@pytest.mark.parametrize("h,v", ORBITS)
def test_replay_matches_plain(scene, h, v, interp, stream, shading):
    """B2 against the plain replay on the card, from the residual and
    re-sampled, and the two kernel routes against each other.  Atomics
    change the summation order from run to run: tolerance, not bits; d_lut
    by the two-group rule of ``parity.check_lut_grad``."""
    p = _diff_params(interp, stream, shading)
    cam = Camera(aspect=W / H, distance=1.3).orbit(h, v, 0.0).matrices()
    feats, vol, lut, sign, grad, u8 = slab_march.prepare(scene, cam, p, H, W)
    img, dens = slab_march.march_cuda(feats, vol, lut, sign, p, grad, u8=u8, emit_density=True)
    g = torch.from_numpy(np.random.default_rng(3).uniform(-1, 1, (H, W, 4)).astype(np.float32)).to(img.device)
    want = slab.replay_slabs(feats, vol, lut, sign, p, img, g, grad, u8, dens)
    got = {}
    for route, d in (("stored", dens), ("re-sampled", None)):
        got[route] = slab_replay.replay_cuda(feats, vol, lut, sign, p, img, g, grad, u8, d)
        torch.cuda.synchronize()
        for name, a, b in zip(("d_vol", "d_grad"), want, got[route]):
            if a is not None:
                assert np.isfinite(b.cpu().numpy()).all()
                parity.check_close(a, b, f"{route} {name}")
        assert np.isfinite(got[route][2].cpu().numpy()).all()
        parity.check_lut_grad(want[2], got[route][2], lut, f"{route} d_lut")
    for name, a, b in zip(("d_vol", "d_grad"), got["stored"], got["re-sampled"]):
        if a is not None:
            parity.check_close(a, b, f"stored vs re-sampled {name}")
    parity.check_lut_grad(got["stored"][2], got["re-sampled"][2], lut, "stored vs re-sampled d_lut")


def test_differentiable_renderer_counts_launches(scene, device):
    p = _diff_params("trilinear", "u8", False)
    vol = scene.volume.clone().requires_grad_(True)
    lut = scene.tf_lut.clone().requires_grad_(True)
    render = make_renderer(Scene(vol, scene.importance, lut), p, H, W, backend="slab_cuda", device=device,
                           differentiable=True)
    cam = Camera(aspect=W / H).orbit(10.0, 5.0, 0.0).matrices()
    b1, b2 = slab_march.LAUNCHES, slab_replay.LAUNCHES
    render(cam).sum().backward()
    assert (slab_march.LAUNCHES, slab_replay.LAUNCHES) == (b1 + 1, b2 + 1)
    plain_vol = scene.volume.clone().requires_grad_(True)
    plain_lut = scene.tf_lut.clone().requires_grad_(True)
    slab.render_diff(Scene(plain_vol, scene.importance, plain_lut), cam, p, H, W).sum().backward()
    parity.check_close(plain_vol.grad, vol.grad, "d_volume")
    parity.check_lut_grad(plain_lut.grad, lut.grad, scene.tf_lut, "d_lut")


def test_replay_cuda_checks_inputs(scene):
    p = _diff_params("trilinear", "u8", False)
    feats, vol, lut, sign, grad, u8 = slab_march.prepare(scene, Camera().matrices(), p, H, W)
    img, dens = slab_march.march_cuda(feats, vol, lut, sign, p, grad, u8=u8, emit_density=True)
    g = torch.ones_like(img)
    with pytest.raises(ValueError, match="dtype"):
        slab_replay.replay_cuda(feats, vol.float(), lut, sign, p, img, g, grad, u8=True)
    with pytest.raises(ValueError, match="contiguous"):
        slab_replay.replay_cuda(feats, vol, lut, sign, p, img, g.transpose(0, 1), grad, u8=u8)
    with pytest.raises(ValueError, match="dens"):
        slab_replay.replay_cuda(feats, vol, lut, sign, p, img, g, grad, u8=u8, dens=dens[:-1])
    with pytest.raises(ValueError, match="on cpu"):
        slab_replay.replay_cuda(feats, vol, lut.cpu(), sign, p, img, g, grad, u8=u8)


@pytest.fixture(scope="module")
def scene3(device):
    """Importance at all three look-ahead levels (chip_smoke's scene)."""
    return convert.scene(*three_level_scene(SIDE), device=device)


def _lookahead_params(stream, cone):
    return RenderParams(
        use_gaussian_smoothing=False, u8_volume=True, use_importance_rendering=True, use_cone_importance_check=cone,
        interpolation="trilinear" if stream == "u8" else "nearest", use_shading=stream == "f32",
        raymarching_step_size=(1.0 if stream == "u8" else 2.0) / SIDE,
    )


@pytest.mark.parametrize("cone", [False, True], ids=["straight", "cone"])
@pytest.mark.parametrize("stream", ["u8", "f32"])
@pytest.mark.parametrize("h,v", ORBITS)
def test_gate_matches_plain(scene3, h, v, stream, cone):
    """B6 (straight) and B7 (cone) against the plain gate, bit for bit; B1
    with the packed gate against the plain march with the plain gate, bit
    for bit."""
    p = _lookahead_params(stream, cone)
    cam = Camera(aspect=W / H, distance=1.3).orbit(h, v, 0.0).matrices()
    feats, vol, lut, sign, grad, u8 = slab_march.prepare(scene3, cam, p, H, W)
    cone_feats, levels = slab_march.lookahead_inputs(scene3, cam, p, H, W)
    before = (lookahead.STRAIGHT_LAUNCHES, lookahead.CONE_LAUNCHES)
    words = lookahead.gate_cuda(feats, cone_feats, levels, sign, p.subtexel_bits)
    assert (lookahead.STRAIGHT_LAUNCHES, lookahead.CONE_LAUNCHES) == (before[0] + (not cone), before[1] + cone)
    want = slab.lookahead_gate(feats, cone_feats, levels, sign, p.subtexel_bits)
    torch.cuda.synchronize()
    assert words.dtype == torch.int32 and tuple(words.shape) == (lookahead.gate_words(vol.shape[0]), H, W)
    parity.check_gate(want, lookahead.unpack_gate(words, vol.shape[0]), f"{stream} cone={cone}")
    assert want.any(), "the gate never engages"
    img = slab_march.march_cuda(feats, vol, lut, sign, p, grad, u8=u8, gate=words)
    plain = slab.march_slabs(feats, vol, lut, sign, p, grad, u8, gate=want)
    torch.cuda.synchronize()
    assert torch.equal(img, plain)


def test_lookahead_renderer_counts_launches(scene3, device):
    p = _lookahead_params("u8", True)
    render = make_renderer(scene3, p, H, W, backend="slab_cuda", device=device)
    cam = Camera(aspect=W / H, distance=1.3).orbit(30.0, 20.0, 0.0).matrices()
    before = (slab_march.LAUNCHES, lookahead.CONE_LAUNCHES)
    img = render(cam)
    assert (slab_march.LAUNCHES, lookahead.CONE_LAUNCHES) == (before[0] + 1, before[1] + 1)
    parity.check_close(slab.render(scene3, cam, p, H, W), img, "cone frame vs plain")


def test_gate_cuda_checks_inputs(scene3):
    p = _lookahead_params("u8", True)
    cam = Camera(aspect=W / H).matrices()
    feats, vol, lut, sign, grad, u8 = slab_march.prepare(scene3, cam, p, H, W)
    cone_feats, levels = slab_march.lookahead_inputs(scene3, cam, p, H, W)
    with pytest.raises(ValueError, match="levels"):
        lookahead.gate_cuda(feats, cone_feats, levels.float(), sign, 8)
    with pytest.raises(ValueError, match="contiguous"):
        lookahead.gate_cuda(feats, cone_feats[:, :, ::2], levels, sign, 8)
    with pytest.raises(ValueError, match="on cpu"):
        lookahead.gate_cuda(feats, cone_feats, levels.cpu(), sign, 8)
    words = lookahead.gate_cuda(feats, None, levels, sign, 8)
    with pytest.raises(ValueError, match="gate"):
        slab_march.march_cuda(feats, vol, lut, sign, p, grad, u8=u8, gate=words[:-1])
    with pytest.raises(NotImplementedError, match="residual"):
        slab_march.march_cuda(feats, vol, lut, sign, p, grad, u8=u8, gate=words, emit_density=True)
