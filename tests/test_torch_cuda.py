"""The CUDA march, replay (with its camera chain and its step range),
voxel-gradient scatter (fused with the smoothing stencil's transpose, and
without it), plain-row camera chain and look-ahead gate kernels against
their plain PyTorch versions, on the card.

Marked ``cuda``: these skip where ``torch.cuda.is_available()`` is false.
Run them on a GPU machine with
``python -m pytest tests/test_torch_cuda.py -q -m cuda``.
"""

import numpy as np
import pytest
import torch

from chip_smoke import three_level_scene
from volym_tpu_torch import Camera, RenderParams, Scene, convert, parity
from volym_tpu_torch.ops import feats_grad, lookahead, slab_march, slab_replay, voxel_grad
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
    assert torch.equal(want, got)
    # 32^3 under 40x56 rays: the tiles' windows fit the stage
    assert slab_march.stage_plan(feats, vol.shape, u8, p).counts()[0] > 0
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
    assert slab_march.stage_plan(feats, vol.shape, u8, p).counts()[0] > 0


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


@pytest.fixture(scope="module")
def scene256(device):
    """256^3, so that every row of the smoothing stencil carries weight
    (|u| up to 2.56 steps at 256 planes)."""
    return Scene.synthetic("bonsai", side=256, seed=1, device=device)


def _smooth_params(interp, stream, shading):
    """Smoothing on the 256^3 scene: u8 at step .005 (256 native planes) or
    f32 at step .01 (128 resampled planes)."""
    return RenderParams(
        use_gaussian_smoothing=True, interpolation=interp, use_shading=shading, u8_volume=True, camera_grads=False,
        raymarching_step_size=0.005 if stream == "u8" else 0.01,
    )


SMOOTH_MODES = [(i, s, sh) for i in ("nearest", "trilinear") for s in ("u8", "f32") for sh in (False, True)]


def _smooth_inputs(scene256, h, v, interp, stream, shading):
    p = _smooth_params(interp, stream, shading)
    cam = Camera(aspect=W / H, distance=1.3).orbit(h, v, 0.0).matrices()
    feats, vol, lut, sign, grad, u8 = slab_march.prepare(scene256, cam, p, H, W)
    assert u8 == (stream == "u8") and vol.shape[0] == (256 if stream == "u8" else 128)
    return p, feats, vol, lut, sign, grad, u8


@pytest.mark.parametrize("interp,stream,shading", SMOOTH_MODES)
@pytest.mark.parametrize("h,v", ORBITS[:2])
def test_smooth_march_matches_plain_bitwise(scene256, h, v, interp, stream, shading):
    """B1 with smoothing against the plain march on the card, image and
    residual bit for bit, and the image unchanged by the residual."""
    p, feats, vol, lut, sign, grad, u8 = _smooth_inputs(scene256, h, v, interp, stream, shading)
    img = slab_march.march_cuda(feats, vol, lut, sign, p, grad, u8=u8)
    img_e, dens = slab_march.march_cuda(feats, vol, lut, sign, p, grad, u8=u8, emit_density=True)
    plain_img, plain_dens = slab.march_slabs(feats, vol, lut, sign, p, grad, u8, emit_density=True)
    torch.cuda.synchronize()
    assert torch.equal(img, img_e) and torch.equal(img, plain_img)
    assert torch.equal(dens, plain_dens)
    assert not torch.equal(img, slab.march_slabs(feats, vol, lut, sign, p.replace(use_gaussian_smoothing=False),
                                                 grad, u8))
    # 256^3 under 40x56 rays: most tiles' windows overflow the stage and
    # read global memory
    staged, direct = slab_march.stage_plan(feats, vol.shape, u8, p).counts()
    assert direct > staged


@pytest.mark.parametrize("config", ["bench", "cli_default_gaussian"])
def test_full_size_frame_stages_bitwise(scene256, config):
    """B1 at 1024x768 on the 256^3 scene: its tiles' windows fit the stage
    (at least 90% of the (block, batch) pairs that read), and the frame and
    its residual are the plain version's bit for bit."""
    p = RenderParams(interpolation="trilinear", density_threshold=0.15, raymarching_step_size=0.005,
                     use_shading=False, use_gaussian_smoothing=False, u8_volume=True)
    if config == "cli_default_gaussian":
        p = RenderParams(interpolation="nearest", density_threshold=0.12, raymarching_step_size=0.01,
                         use_shading=True, use_gaussian_smoothing=True, u8_volume=True)
    cam = Camera(aspect=1024 / 768).orbit(2.0, 0.0, 0.0).matrices()
    feats, vol, lut, sign, grad, u8 = slab_march.prepare(scene256, cam, p, 768, 1024)
    staged, direct = slab_march.stage_plan(feats, vol.shape, u8, p).counts()
    assert staged >= 9 * direct and staged > 0
    img = slab_march.march_cuda(feats, vol, lut, sign, p, grad, u8=u8)
    img_e, dens = slab_march.march_cuda(feats, vol, lut, sign, p, grad, u8=u8, emit_density=True)
    plain_img, plain_dens = slab.march_slabs(feats, vol, lut, sign, p, grad, u8, emit_density=True)
    torch.cuda.synchronize()
    assert torch.equal(img, plain_img) and torch.equal(img_e, plain_img)
    assert torch.equal(dens, plain_dens)


def _fold(feats, dd, vol_shape, p):
    """The replay's per-step cotangents with the density channel folded onto
    the plain rows (the stencil's transpose), the others as they are: what
    the scatter without the fold takes."""
    _, nr, nc = vol_shape
    bilinear = p.interpolation.value == "trilinear"
    if dd.dim() == 4:
        return torch.cat([slab.smooth_dd_transpose(feats, dd[:, 0], nr, nc, bilinear)[:, None], dd[:, 1:]], dim=1)
    return slab.smooth_dd_transpose(feats, dd, nr, nc, bilinear)


@pytest.mark.parametrize("interp,stream,shading", SMOOTH_MODES)
@pytest.mark.parametrize("h,v", ORBITS[:2])
def test_smooth_replay_and_scatter_match_plain(scene256, h, v, interp, stream, shading):
    """B2 unfused against the plain replay from the residual and
    re-sampled (the per-step cotangents on each ray's step range, where the
    kernel writes them, by the repo rule, and the step range bit for bit;
    the two kernel routes' cotangents on the range bit for bit: no atomics
    write them; d_lut by the two-group rule), then B3 (unshaded) or B4
    (shaded) without the fold against the plain scatter on the folded
    cotangents, by the repo rule (atomics reorder the sums)."""
    p, feats, vol, lut, sign, grad, u8 = _smooth_inputs(scene256, h, v, interp, stream, shading)
    img, dens = slab_march.march_cuda(feats, vol, lut, sign, p, grad, u8=u8, emit_density=True)
    g = torch.from_numpy(np.random.default_rng(3).uniform(-1, 1, (H, W, 4)).astype(np.float32)).to(img.device)
    want_dd, want_steps, want_lut = slab.replay_slabs(feats, vol, lut, sign, p, img, g, grad, u8, dens)
    got = {route: slab_replay.replay_cuda(feats, vol, lut, sign, p, img, g, grad, u8, d)
           for route, d in (("stored", dens), ("re-sampled", None))}
    torch.cuda.synchronize()
    assert torch.equal(slab.dense_dd(want_dd, want_steps), want_dd)
    ranged = {}
    for route, (dd, steps, d_lut) in got.items():
        assert torch.equal(want_steps, steps), f"{route} step range"
        ranged[route] = slab.dense_dd(dd, steps)
        parity.check_close(want_dd, ranged[route], f"{route} dd")
        parity.check_lut_grad(want_lut, d_lut, lut, f"{route} d_lut")
    assert torch.equal(ranged["stored"], ranged["re-sampled"])
    assert float(want_dd.abs().max()) > 0
    dd = _fold(feats, want_dd, vol.shape, p)
    before = (voxel_grad.LAUNCHES, voxel_grad.SHADED_LAUNCHES)
    d_vol, d_grad = voxel_grad.scatter_cuda(feats, dd, vol.shape, sign, p)
    assert (voxel_grad.LAUNCHES, voxel_grad.SHADED_LAUNCHES) == (before[0] + (not shading), before[1] + shading)
    plain_vol, plain_grad = slab.voxel_grad(feats, dd, vol.shape, sign, p)
    torch.cuda.synchronize()
    parity.check_close(plain_vol, d_vol, "d_vol")
    if shading:
        parity.check_close(plain_grad, d_grad, "d_grad")
    else:
        assert d_grad is None


@pytest.mark.parametrize("folded", [False, True])
@pytest.mark.parametrize("shading", [False, True])
@pytest.mark.parametrize("interp", ["nearest", "trilinear"])
@pytest.mark.parametrize("h,v", ORBITS)
def test_fold_scatter_matches_plain(scene256, h, v, interp, shading, folded):
    """The fused fold-and-scatter (B3 unshaded, B4 shaded) against
    ``slab.smooth_voxel_grad`` on the plain replay's cotangents and step
    range, 256 planes: d_vol and d_grad by the repo rule (atomics reorder
    the sums), the folded rows with one source an offset (1 <= k <= N-2)
    bit for bit and the two end rows by the repo rule; with the rows cut
    into the default chunks (``voxel_grad.fold_chunk``) and into chunks of
    7 rows."""
    p, feats, vol, lut, sign, grad, u8 = _smooth_inputs(scene256, h, v, interp, "u8", shading)
    img = slab_march.march_cuda(feats, vol, lut, sign, p, grad, u8=u8)
    g = torch.from_numpy(np.random.default_rng(3).uniform(-1, 1, (H, W, 4)).astype(np.float32)).to(img.device)
    dd, steps, _ = slab.replay_slabs(feats, vol, lut, sign, p, img, g, grad, u8)
    want_vol, want_grad, want_rows = slab.smooth_voxel_grad(feats, dd, steps, vol.shape, sign, p, want_folded=True)
    assert float(want_vol.abs().max()) > 0
    for chunk in (None, 7):
        before = (voxel_grad.FOLD_LAUNCHES, voxel_grad.FOLD_SHADED_LAUNCHES)
        d_vol, d_grad, rows = voxel_grad.fold_scatter_cuda(feats, dd, steps, vol.shape, sign, p, folded, chunk)
        torch.cuda.synchronize()
        assert (voxel_grad.FOLD_LAUNCHES, voxel_grad.FOLD_SHADED_LAUNCHES) == (before[0] + (not shading),
                                                                                before[1] + shading)
        parity.check_close(want_vol, d_vol, f"chunk={chunk} d_vol")
        if shading:
            parity.check_close(want_grad, d_grad, f"chunk={chunk} d_grad")
        else:
            assert d_grad is None
        if not folded:
            assert rows is None
            continue
        assert torch.equal(want_rows[1:-1], rows[1:-1]), f"chunk={chunk}: folded rows differ"
        parity.check_close(want_rows[[0, -1]], rows[[0, -1]], f"chunk={chunk} folded end rows")


def _nan_fill(shape, **kwargs):
    return torch.full(shape, float("nan"), **kwargs)


@pytest.mark.parametrize("camera", [False, True])
@pytest.mark.parametrize("interp,shading", [("trilinear", False), ("nearest", True), ("trilinear", True)])
def test_dd_outside_the_step_range_is_never_read(scene256, device, monkeypatch, interp, shading, camera):
    """The replay writes dd only on each ray's step range: with its
    allocation NaN-filled instead of left as it is, the fused
    fold-and-scatter's d_vol / d_grad and the whole smoothed training
    step's gradients (camera ones too) stay finite and agree with a
    zero-filled run by the repo rule (atomics reorder the sums)."""
    p = RenderParams(use_gaussian_smoothing=True, interpolation=interp, use_shading=shading,
                     raymarching_step_size=0.005, camera_grads=camera)
    cam = Camera(aspect=W / H, distance=1.3).orbit(30.0, 20.0, 0.0).matrices()
    feats, vol, lut, sign, grad, u8 = slab_march.prepare(scene256, cam, p, H, W)
    img = slab_march.march_cuda(feats, vol, lut, sign, p, grad, u8=u8)
    g = torch.from_numpy(np.random.default_rng(3).uniform(-1, 1, (H, W, 4)).astype(np.float32)).to(device)
    chain = camera and interp == "trilinear"

    def run():
        dd, steps = slab_replay.replay_cuda(feats, vol, lut, sign, p, img, g, grad, u8)[:2]
        fold = voxel_grad.fold_scatter_cuda(feats, dd, steps, vol.shape, sign, p, chain)
        scene = Scene(scene256.volume.clone().requires_grad_(True), scene256.importance,
                      scene256.tf_lut.clone().requires_grad_(True))
        cm = Camera(aspect=W / H).orbit(10.0, 5.0, 0.0).matrices()
        leaves = [scene.volume, scene.tf_lut]
        if camera:
            leaves += [cm.inverse_view_proj.requires_grad_(True), cm.position.requires_grad_(True)]
        make_renderer(scene, p, H, W, backend="slab_cuda", device=device, differentiable=True)(cm).sum().backward()
        torch.cuda.synchronize()
        return dd, steps, fold, [t.grad for t in leaves]

    monkeypatch.setattr(slab_replay, "ALLOC_DD", torch.zeros)
    _, _, want_fold, want_grads = run()
    monkeypatch.setattr(slab_replay, "ALLOC_DD", _nan_fill)
    dd, steps, fold, grads = run()
    outside = ~(slab.dense_dd(torch.ones_like(dd), steps) > 0.0)
    assert bool(outside.any()) and bool(dd[outside].isnan().all()), "the NaN fill did not stay outside the ranges"
    for name, a, b in zip(("d_vol", "d_grad", "folded rows"), want_fold, fold):
        if a is not None:
            assert bool(torch.isfinite(b).all()), name
            parity.check_close(a, b, name)
    assert float(want_grads[0].abs().max()) > 0
    for name, a, b in zip(("d_volume", "d_lut", "d_inverse_view_proj", "d_position"), want_grads, grads):
        assert bool(torch.isfinite(b).all()), name
        if name == "d_lut":
            parity.check_lut_grad(a, b, scene256.tf_lut, name)
        else:
            parity.check_close(a, b, name)


@pytest.mark.parametrize("shading", [False, True])
def test_smooth_differentiable_renderer_counts_launches(scene256, device, shading):
    """The training step under smoothing launches B1, B2 and the fused
    fold-and-scatter (B3, or B4 when shaded) once each, and not the scatter
    without the fold, and its gradients agree with the plain step's."""
    p = _smooth_params("trilinear" if not shading else "nearest", "u8" if not shading else "f32", shading)
    vol = scene256.volume.clone().requires_grad_(True)
    lut = scene256.tf_lut.clone().requires_grad_(True)
    render = make_renderer(Scene(vol, scene256.importance, lut), p, H, W, backend="slab_cuda", device=device,
                           differentiable=True)
    cam = Camera(aspect=W / H).orbit(10.0, 5.0, 0.0).matrices()

    def counts():
        return (slab_march.LAUNCHES, slab_replay.LAUNCHES, voxel_grad.FOLD_LAUNCHES, voxel_grad.FOLD_SHADED_LAUNCHES,
                voxel_grad.LAUNCHES, voxel_grad.SHADED_LAUNCHES)

    before = counts()
    render(cam).sum().backward()
    assert tuple(a - b for a, b in zip(counts(), before)) == (1, 1, int(not shading), int(shading), 0, 0)
    plain_vol = scene256.volume.clone().requires_grad_(True)
    plain_lut = scene256.tf_lut.clone().requires_grad_(True)
    slab.render_diff(Scene(plain_vol, scene256.importance, plain_lut), cam, p, H, W).sum().backward()
    parity.check_close(plain_vol.grad, vol.grad, "d_volume")
    parity.check_lut_grad(plain_lut.grad, lut.grad, scene256.tf_lut, "d_lut")


def test_default_renderer_smooths_on_the_card(scene256, device):
    """``RenderParams()`` (smoothing on, nearest, shaded, step .01 -> 128
    planes) through the CUDA march, bit for bit with the plain render."""
    render = make_renderer(scene256, RenderParams(), H, W, device=device)
    cam = Camera(aspect=W / H).orbit(10.0, 5.0, 0.0).matrices()
    before = slab_march.LAUNCHES
    img = render(cam)
    assert slab_march.LAUNCHES == before + 1
    assert torch.equal(img, slab.render(scene256, cam, RenderParams(), H, W))


def test_smoothing_kernels_check_inputs(scene256):
    p, feats, vol, lut, sign, grad, u8 = _smooth_inputs(scene256, 30.0, 20.0, "trilinear", "u8", True)
    big = torch.zeros((304, vol.shape[1], vol.shape[2]), dtype=vol.dtype, device=vol.device)
    with pytest.raises(NotImplementedError, match="300"):
        slab_march.march_cuda(feats, big, lut, sign, p, grad.new_zeros((3, *big.shape)), u8=u8)
    dd = torch.zeros((vol.shape[0], 4, H, W), device=vol.device)
    with pytest.raises(ValueError, match="dd"):
        voxel_grad.scatter_cuda(feats, dd[:, :3], vol.shape, sign, p)
    with pytest.raises(ValueError, match="on cpu"):
        voxel_grad.scatter_cuda(feats, dd.cpu(), vol.shape, sign, p)
    steps = torch.zeros((2, H, W), dtype=torch.int32, device=vol.device)
    with pytest.raises(ValueError, match="steps"):
        voxel_grad.fold_scatter_cuda(feats, dd, steps.long(), vol.shape, sign, p)
    with pytest.raises(ValueError, match="steps"):
        voxel_grad.fold_scatter_cuda(feats, dd, steps[:, :-1], vol.shape, sign, p)
    with pytest.raises(ValueError, match="dd"):
        voxel_grad.fold_scatter_cuda(feats, dd[:, :3], steps, vol.shape, sign, p)


#: camera gradients: (interpolation, shading, smoothing), every mode
CAMERA_MODES = [(i, sh, sm) for i in ("nearest", "trilinear") for sh in (False, True) for sm in (False, True)]


def _camera_inputs(scene, scene256, h, v, interp, shading, smooth):
    """f32 inputs with ``camera_grads=True``: the 32^3 scene at native
    planes unsmoothed, the 256^3 scene at 256 planes under smoothing."""
    p = RenderParams(use_gaussian_smoothing=smooth, interpolation=interp, use_shading=shading,
                     raymarching_step_size=0.005 if smooth else 1.0 / SIDE)
    s = scene256 if smooth else scene
    cam = Camera(aspect=W / H, distance=1.3).orbit(h, v, 0.0).matrices()
    feats, vol, lut, sign, grad, u8 = slab_march.prepare(s, cam, p, H, W)
    assert not u8 and vol.dtype == torch.float32
    return p, feats, vol, lut, sign, grad


@pytest.mark.parametrize("interp,shading,smooth", CAMERA_MODES)
@pytest.mark.parametrize("h,v", ORBITS[:2])
def test_camera_replay_and_feats_grad_match_plain(scene, scene256, h, v, interp, shading, smooth):
    """B2's camera mode against the plain replay (d_feats and the other
    outputs by the repo rule, d_lut by the two-group rule), and under
    trilinear smoothing B5 against the plain rows' chain on the folded
    cotangents, read through a channel view when shaded."""
    p, feats, vol, lut, sign, grad = _camera_inputs(scene, scene256, h, v, interp, shading, smooth)
    img = slab_march.march_cuda(feats, vol, lut, sign, p, grad)
    g = torch.from_numpy(np.random.default_rng(3).uniform(-1, 1, (H, W, 4)).astype(np.float32)).to(img.device)
    want = slab.replay_slabs(feats, vol, lut, sign, p, img, g, grad)
    got = slab_replay.replay_cuda(feats, vol, lut, sign, p, img, g, grad)
    torch.cuda.synchronize()
    assert len(got) == len(want)
    if smooth:  # dd is written on each ray's step range only
        got = (slab.dense_dd(got[0], got[1]), *got[1:])
    for a, b in zip(want[:-2], got[:-2]):
        if a is not None:
            parity.check_close(a, b, "replay")
    parity.check_lut_grad(want[-2], got[-2], lut, "d_lut")
    assert float(want[-1].abs().max()) > 0
    parity.check_close(want[-1], got[-1], "d_feats")
    if smooth:
        assert torch.equal(want[1], got[1]), "step range"
    if smooth and interp == "trilinear":
        plain_dd = slab.smooth_voxel_grad(feats, want[0], want[1], vol.shape, sign, p, want_folded=True)[2]
        before = feats_grad.LAUNCHES
        b5 = feats_grad.feats_grad_cuda(feats, vol, plain_dd, sign, p)
        assert feats_grad.LAUNCHES == before + 1
        plain_b5 = slab.feats_grad(feats, vol, plain_dd, sign, p)
        torch.cuda.synchronize()
        assert float(plain_b5.abs().max()) > 0
        parity.check_close(plain_b5, b5, "feats_grad")


@pytest.mark.parametrize("interp,shading", [("trilinear", False), ("nearest", True), ("trilinear", True)])
def test_camera_differentiable_renderer_counts_launches(scene256, device, interp, shading):
    """The smoothed training step with camera gradients launches B1, B2, B3
    (or B4 when shaded) and, with trilinear sampling, B5 once each; its
    image, volume, LUT and camera gradients agree with the plain step's."""
    p = RenderParams(interpolation=interp, use_shading=shading, raymarching_step_size=0.005)

    def step(render_fn):
        vol = scene256.volume.clone().requires_grad_(True)
        lut = scene256.tf_lut.clone().requires_grad_(True)
        cam = Camera(aspect=W / H).orbit(10.0, 5.0, 0.0).matrices()
        cam.inverse_view_proj.requires_grad_(True)
        cam.position.requires_grad_(True)
        img = render_fn(Scene(vol, scene256.importance, lut))(cam)
        img.sum().backward()
        return img.detach(), vol.grad, lut.grad, {"inverse_view_proj": cam.inverse_view_proj.grad,
                                                  "position": cam.position.grad, "view": cam.view.grad}

    def counts():
        return (slab_march.LAUNCHES, slab_replay.LAUNCHES, voxel_grad.FOLD_LAUNCHES, voxel_grad.FOLD_SHADED_LAUNCHES,
                feats_grad.LAUNCHES)

    before = counts()
    got = step(lambda s: make_renderer(s, p, H, W, backend="slab_cuda", device=device, differentiable=True))
    launched = tuple(a - b for a, b in zip(counts(), before))
    assert launched == (1, 1, int(not shading), int(shading), int(interp == "trilinear"))
    want = step(lambda s: make_renderer(s, p, H, W, backend="slab", device=device, differentiable=True))
    assert torch.equal(want[0], got[0])
    parity.check_close(want[1], got[1], "d_volume")
    parity.check_lut_grad(want[2], got[2], scene256.tf_lut, "d_lut")
    assert float(got[3]["position"].abs().max()) > 0 and got[3]["view"] is None
    parity.check_camera_grad(want[3], got[3], "camera")


def test_feats_grad_cuda_checks_inputs(scene256):
    p, feats, vol, lut, sign, grad = _camera_inputs(scene256, scene256, 30.0, 20.0, "trilinear", True, True)
    dd = torch.zeros((vol.shape[0], 4, H, W), device=vol.device)
    with pytest.raises(ValueError, match="trilinear"):
        feats_grad.feats_grad_cuda(feats, vol, dd[:, 0], sign, p.replace(interpolation="nearest"))
    with pytest.raises(ValueError, match="dd"):
        feats_grad.feats_grad_cuda(feats, vol, dd[:-1, 0], sign, p)
    with pytest.raises(ValueError, match="planes must be contiguous"):
        feats_grad.feats_grad_cuda(feats, vol, torch.zeros_like(dd[:, :2]).reshape(-1, H, 2 * W)[:vol.shape[0], :, ::2],
                                   sign, p)
    with pytest.raises(ValueError, match="on cpu"):
        feats_grad.feats_grad_cuda(feats, vol.cpu(), dd[:, 0], sign, p)
    with pytest.raises(ValueError, match="re-sampled replay"):
        slab_replay.replay_cuda(feats, vol, lut, sign, p, dd[0, :3].permute(1, 2, 0).contiguous(),
                                torch.zeros((H, W, 4), device=vol.device), grad, dens=dd[:, :1])
