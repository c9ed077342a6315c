"""The CUDA march, replay (with its camera chain and its step range),
voxel-gradient scatter (fused with the smoothing stencil's transpose, with
the plain rows' camera chain fused into that, and without it), look-ahead
gate and per-ray and cone table kernels against their plain PyTorch
versions, on the card.

Marked ``cuda``: these skip where ``torch.cuda.is_available()`` is false.
Run them on a GPU machine with
``python -m pytest tests/test_torch_cuda.py -q -m cuda``.
"""

import math

import numpy as np
import pytest
import torch

from chip_smoke import three_level_scene
from volym_tpu_torch import Camera, RenderParams, Scene, convert, parity
from volym_tpu_torch.camera import camera_matrices
from volym_tpu_torch.ops import feats_grad, lookahead, ray_table, slab_march, slab_replay, voxel_grad
from volym_tpu_torch.render import rays as rays_mod
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


def _straight_case(feats, levels, case):
    """(feats, levels) of one of B6's edge cases, made from a frame's own:
    no importance; every texel important (a sixth opaque), so that no tap
    is skipped; important texels only on row 0 of every slice with half
    the rays (by the parity of their ``tb`` bits) shifted 4 rows below it,
    so that their clamped coordinate taps row 0; or a tiny ``ts`` on half
    the rays, each held inside its window, so that the proof that no bit
    is set while ``ns`` is FAR fails and the range test sets bits."""
    odd = (feats[slab.F_TB].view(torch.int32) & 1).bool()
    if case == "tiny ts":
        feats = feats.clone()
        feats[slab.F_TS] = torch.where(odd, feats[slab.F_TS] * 1e-9, feats[slab.F_TS])
        feats[slab.F_TB] = torch.where(odd, (feats[slab.F_ENTRY] + feats[slab.F_EXIT]) * 0.5, feats[slab.F_TB])
        return feats, levels
    if case == "empty":
        return feats, torch.zeros_like(levels)
    if case == "everywhere":
        return feats, (torch.arange(levels.numel(), device=levels.device) % 6 == 0).to(torch.uint8).reshape(
            levels.shape) + 1
    levels = torch.zeros_like(levels)
    levels[:, 0, :] = 1
    levels[::3] *= 2
    feats = feats.clone()
    feats[slab.F_RB] = torch.where(odd, feats[slab.F_RB] - 4.0, feats[slab.F_RB])
    return feats, levels


@pytest.mark.parametrize("case", ["empty", "everywhere", "clamped edge", "tiny ts"])
@pytest.mark.parametrize("stream", ["u8", "f32"])
@pytest.mark.parametrize("h,v", [(30.0, 20.0), (300.0, -10.0)])
def test_straight_gate_edge_cases_match_plain(scene3, h, v, stream, case):
    """B6 on no importance, importance everywhere, clamped edge taps and a
    tiny ``ts``, bit for bit with the plain gate; B1 with that gate bit for
    bit with the plain march."""
    p = _lookahead_params(stream, False)
    cam = Camera(aspect=W / H, distance=1.3).orbit(h, v, 0.0).matrices()
    feats, vol, lut, sign, grad, u8 = slab_march.prepare(scene3, cam, p, H, W)
    _, levels = slab_march.lookahead_inputs(scene3, cam, p, H, W)
    feats, levels = _straight_case(feats, levels, case)
    words = lookahead.gate_cuda(feats, None, levels, sign, p.subtexel_bits)
    want = slab.lookahead_gate(feats, None, levels, sign, p.subtexel_bits)
    torch.cuda.synchronize()
    parity.check_gate(want, lookahead.unpack_gate(words, vol.shape[0]), f"{stream} {case}")
    assert bool(want.any()) == (case != "empty")
    img = slab_march.march_cuda(feats, vol, lut, sign, p, grad, u8=u8, gate=words)
    plain = slab.march_slabs(feats, vol, lut, sign, p, grad, u8, gate=want)
    torch.cuda.synchronize()
    assert torch.equal(img, plain)


@pytest.mark.parametrize("cone", [False, True], ids=["straight", "cone"])
@pytest.mark.parametrize("h,v", [(30.0, 20.0), (120.0, 10.0)])
def test_gate_matches_plain_on_rows_of_no_whole_chunks(device, h, v, cone):
    """A 24^3 scene: its level rows are not whole 16-byte chunks, so the
    bounds pass reads bytes; B6 and B7 still equal the plain gate."""
    scene24 = convert.scene(*three_level_scene(24), device=device)
    p = _lookahead_params("u8", cone)
    cam = Camera(aspect=W / H, distance=1.3).orbit(h, v, 0.0).matrices()
    feats, vol, _, sign, _, _ = slab_march.prepare(scene24, cam, p, H, W)
    cone_feats, levels = slab_march.lookahead_inputs(scene24, cam, p, H, W)
    assert levels.shape[2] % 16 != 0
    words = lookahead.gate_cuda(feats, cone_feats, levels, sign, p.subtexel_bits)
    want = slab.lookahead_gate(feats, cone_feats, levels, sign, p.subtexel_bits)
    torch.cuda.synchronize()
    assert want.any(), "the gate never engages"
    parity.check_gate(want, lookahead.unpack_gate(words, vol.shape[0]), f"24^3 cone={cone}")


@pytest.mark.parametrize("cone", [False, True], ids=["straight", "cone"])
def test_gate_cuda_passes_the_bounds_scratch(scene3, monkeypatch, cone):
    """Both variants run after the bounds pass: gate_cuda hands the kernel
    an (n, 4) int32 scratch, straight as well as cone."""
    p = _lookahead_params("u8", cone)
    cam = Camera(aspect=W / H, distance=1.3).matrices()
    feats, vol, _, sign, _, _ = slab_march.prepare(scene3, cam, p, H, W)
    cone_feats, levels = slab_march.lookahead_inputs(scene3, cam, p, H, W)
    launch, scratch = lookahead._library(), []

    def spy(*args):
        scratch.append(args[-1])
        return launch(*args)

    monkeypatch.setattr(lookahead, "_library", lambda: spy)
    words = lookahead.gate_cuda(feats, cone_feats, levels, sign, p.subtexel_bits)
    torch.cuda.synchronize()
    assert len(scratch) == 1 and scratch[0]
    parity.check_gate(slab.lookahead_gate(feats, cone_feats, levels, sign, p.subtexel_bits),
                      lookahead.unpack_gate(words, vol.shape[0]), f"cone={cone}")


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
    # the gated residual runs, bit for bit with the plain march's
    img, dens = slab_march.march_cuda(feats, vol, lut, sign, p, grad, u8=u8, gate=words, emit_density=True)
    want_img, want_dens = slab.march_slabs(feats, vol, lut, sign, p, grad, u8, emit_density=True,
                                           gate=lookahead.unpack_gate(words, vol.shape[0]))
    torch.cuda.synchronize()
    assert torch.equal(img, want_img) and torch.equal(dens, want_dens)


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
    zero-filled run by the repo rule (atomics reorder the sums); with
    camera gradients and trilinear sampling the fold's d_feats (the plain
    rows' camera chain fused in) too."""
    p = RenderParams(use_gaussian_smoothing=True, interpolation=interp, use_shading=shading,
                     raymarching_step_size=0.005, camera_grads=camera)
    cam = Camera(aspect=W / H, distance=1.3).orbit(30.0, 20.0, 0.0).matrices()
    feats, vol, lut, sign, grad, u8 = slab_march.prepare(scene256, cam, p, H, W)
    img = slab_march.march_cuda(feats, vol, lut, sign, p, grad, u8=u8)
    g = torch.from_numpy(np.random.default_rng(3).uniform(-1, 1, (H, W, 4)).astype(np.float32)).to(device)
    chain = camera and interp == "trilinear"

    def run():
        dd, steps = slab_replay.replay_cuda(feats, vol, lut, sign, p, img, g, grad, u8)[:2]
        fold = voxel_grad.fold_scatter_cuda(feats, dd, steps, vol.shape, sign, p, vol=vol if chain else None)
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
    assert (fold[2] is not None) == chain
    for name, a, b in zip(("d_vol", "d_grad", "d_feats"), want_fold, fold):
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
    trilinear smoothing B5, fused into the fold, on B2's cotangents against
    the plain rows' chain on the plain folded cotangents: by the repo rule
    with the default chunks of rows, bit for bit with one chunk against the
    plain chain on the fold's own folded rows."""
    p, feats, vol, lut, sign, grad = _camera_inputs(scene, scene256, h, v, interp, shading, smooth)
    img = slab_march.march_cuda(feats, vol, lut, sign, p, grad)
    g = torch.from_numpy(np.random.default_rng(3).uniform(-1, 1, (H, W, 4)).astype(np.float32)).to(img.device)
    want = slab.replay_slabs(feats, vol, lut, sign, p, img, g, grad)
    got = slab_replay.replay_cuda(feats, vol, lut, sign, p, img, g, grad)
    torch.cuda.synchronize()
    assert len(got) == len(want)
    raw_dd = got[0]
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
        plain_vol, plain_grad, plain_dd = slab.smooth_voxel_grad(feats, want[0], want[1], vol.shape, sign, p,
                                                                 want_folded=True)
        plain_b5 = slab.feats_grad(feats, vol, plain_dd, sign, p)
        assert float(plain_b5.abs().max()) > 0
        n = vol.shape[0]
        for chunk in (None, n):
            before = (feats_grad.LAUNCHES, voxel_grad.FOLD_LAUNCHES + voxel_grad.FOLD_SHADED_LAUNCHES)
            d_vol, d_grad, b5 = voxel_grad.fold_scatter_cuda(feats, raw_dd, got[1], vol.shape, sign, p, chunk=chunk,
                                                             vol=vol)
            torch.cuda.synchronize()
            assert (feats_grad.LAUNCHES, voxel_grad.FOLD_LAUNCHES + voxel_grad.FOLD_SHADED_LAUNCHES) == (
                before[0] + 1, before[1] + 1)
            parity.check_close(plain_b5, b5, f"feats_grad chunk={chunk}")
            parity.check_close(plain_vol, d_vol, f"d_vol chunk={chunk}")
            if shading:
                parity.check_close(plain_grad, d_grad, f"d_grad chunk={chunk}")
        rows = voxel_grad.fold_scatter_cuda(feats, raw_dd, got[1], vol.shape, sign, p, True, n)[2]
        assert torch.equal(slab.feats_grad(feats, vol, rows, sign, p), b5), "one chunk: not the plain chain's bits"


@pytest.mark.parametrize("interp,shading", [("trilinear", False), ("nearest", True), ("trilinear", True)])
def test_camera_differentiable_renderer_counts_launches(scene256, device, interp, shading):
    """The smoothed training step with camera gradients launches B1, B2, B3
    (or B4 when shaded) once each, with trilinear sampling B3 (B4) with B5
    fused in; its image, volume, LUT and camera gradients agree with the
    plain step's."""
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


def test_camera_step_allocates_no_folded_rows(scene256, device):
    """The 1024x768 smoothed camera step (trilinear, 256 planes) makes no
    (N, H, W) tensor of folded rows: its peak memory lies at least N x H x W
    float32 (less 32 MiB) below the same step whose fold writes the folded
    rows for a plain chain that walks them, with which its gradients agree
    by the repo rule."""
    h, w = 768, 1024
    p = RenderParams(interpolation="trilinear", use_shading=False, raymarching_step_size=0.005,
                     density_threshold=0.15)

    def step(**fns):
        vol = scene256.volume.clone().requires_grad_(True)
        lut = scene256.tf_lut.clone().requires_grad_(True)
        cam = Camera(aspect=w / h).orbit(10.0, 5.0, 0.0).matrices()
        cam.inverse_view_proj.requires_grad_(True)
        cam.position.requires_grad_(True)
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        slab_march.render_diff(Scene(vol, scene256.importance, lut), cam, p, h, w, **fns).sum().backward()
        torch.cuda.synchronize()
        return torch.cuda.max_memory_allocated() - before, vol.grad, cam.position.grad

    n = slab.resolve_planes(p, 256)
    launched = feats_grad.LAUNCHES
    fused = step()
    assert feats_grad.LAUNCHES == launched + 1
    rows = step(scatter_fn=voxel_grad.fold_scatter_cuda, feats_grad_fn=slab.feats_grad)
    assert feats_grad.LAUNCHES == launched + 1
    assert rows[0] - fused[0] >= n * h * w * 4 - 32 * 2**20, (rows[0], fused[0])
    parity.check_close(rows[1], fused[1], "d_volume")
    parity.check_close(rows[2], fused[2], "d_position")


def test_feats_grad_cuda_checks_inputs(scene256):
    """The fused chain's entry (``fold_scatter_cuda`` with ``vol``) refuses
    what it does not take, and the plain rows' chain alone does not run on
    CUDA tensors (it runs fused into the fold there)."""
    p, feats, vol, lut, sign, grad = _camera_inputs(scene256, scene256, 30.0, 20.0, "trilinear", True, True)
    dd = torch.zeros((vol.shape[0], 4, H, W), device=vol.device)
    steps = torch.zeros((2, H, W), dtype=torch.int32, device=vol.device)
    with pytest.raises(ValueError, match="trilinear"):
        voxel_grad.fold_scatter_cuda(feats, dd, steps, vol.shape, sign, p.replace(interpolation="nearest"), vol=vol)
    with pytest.raises(ValueError, match="vol must be"):
        voxel_grad.fold_scatter_cuda(feats, dd, steps, vol.shape, sign, p, vol=vol[:-1])
    with pytest.raises(ValueError, match="vol must be"):
        voxel_grad.fold_scatter_cuda(feats, dd, steps, vol.shape, sign, p, vol=vol.double())
    with pytest.raises(ValueError, match="contiguous"):
        voxel_grad.fold_scatter_cuda(feats, dd, steps, vol.shape, sign, p, vol=vol.transpose(1, 2))
    with pytest.raises(ValueError, match="on cpu"):
        voxel_grad.fold_scatter_cuda(feats, dd, steps, vol.shape, sign, p, vol=vol.cpu())
    with pytest.raises(ValueError, match="want_folded"):
        voxel_grad.fold_scatter_cuda(feats, dd, steps, vol.shape, sign, p, True, vol=vol)
    with pytest.raises(ValueError, match="fused into the fold"):
        feats_grad.feats_grad(feats, vol, dd[:, 0], sign, p)
    with pytest.raises(ValueError, match="re-sampled replay"):
        slab_replay.replay_cuda(feats, vol, lut, sign, p, dd[0, :3].permute(1, 2, 0).contiguous(),
                                torch.zeros((H, W, 4), device=vol.device), grad, dens=dd[:, :1])


#: the new modes' cases: (interpolation, stream, shading, smoothing)
MODE_CASES = [(i, s, sh, sm) for i in ("nearest", "trilinear") for s in ("u8", "f32") for sh in (False, True)
              for sm in (False, True)]


def _mode_inputs(scene3, h, v, interp, stream, shading, smooth, **kw):
    """The 32^3 three-level scene (importance at every level), u8 on native
    planes or f32 on resampled ones -> (p, feats, vol, lut, sign, grad, u8,
    imp_perm)."""
    p = RenderParams(use_gaussian_smoothing=smooth, interpolation=interp, use_shading=shading, u8_volume=True,
                     camera_grads=False, raymarching_step_size=(1.0 if stream == "u8" else 2.0) / SIDE, **kw)
    cam = Camera(aspect=W / H, distance=1.3).orbit(h, v, 0.0).matrices()
    feats, vol, lut, sign, grad, u8 = slab_march.prepare(scene3, cam, p, H, W)
    assert u8 == (stream == "u8")
    imp = slab_march.importance_perm(scene3.importance, slab.dominant_axis(cam)[0], vol.shape[0]).contiguous()
    return p, cam, feats, vol, lut, sign, grad, u8, imp


@pytest.mark.parametrize("interp,stream,shading,smooth", MODE_CASES)
@pytest.mark.parametrize("h,v", ORBITS[:2])
def test_coloring_march_and_replay_match_plain(scene3, h, v, interp, stream, shading, smooth):
    """B1's coloring bit for bit with the plain march (with first-hit asked
    for too: coloring still composites), and B2's coloring route (d_imp by
    box-hat atomics, d_grad when shaded, fused under smoothing too, no
    d_lut) against the plain replay by the repo rule."""
    p, cam, feats, vol, lut, sign, grad, u8, imp = _mode_inputs(scene3, h, v, interp, stream, shading, smooth,
                                                                use_importance_coloring=True)
    before = slab_march.LAUNCHES
    img = slab_march.march_cuda(feats, vol, lut, sign, p, grad, u8=u8, imp_perm=imp)
    assert slab_march.LAUNCHES == before + 1
    want = slab.march_slabs(feats, vol, lut, sign, p, grad, u8, imp_perm=imp)
    torch.cuda.synchronize()
    assert torch.equal(img, want)
    assert not torch.equal(img, slab.march_slabs(feats, vol, lut, sign, p.replace(use_importance_coloring=False),
                                                 grad, u8))
    opaque = p.replace(use_opacity=False)
    assert torch.equal(slab_march.march_cuda(feats, vol, lut, sign, opaque, grad, u8=u8, imp_perm=imp), img)
    g = torch.from_numpy(np.random.default_rng(3).uniform(-1, 1, (H, W, 4)).astype(np.float32)).to(img.device)
    plain = slab.replay_slabs(feats, vol, lut, sign, p, img, g, grad, u8, imp_perm=imp)
    got = slab_replay.replay_cuda(feats, vol, lut, sign, p, img, g, grad, u8, imp_perm=imp)
    torch.cuda.synchronize()
    assert float(plain[0].abs().max()) > 0 and not bool(got[2].any())
    parity.check_close(plain[0], got[0], "d_imp")
    if shading:
        parity.check_close(plain[1], got[1], "d_grad")
    else:
        assert got[1] is None


@pytest.mark.parametrize("interp,shading,smooth", CAMERA_MODES)
def test_coloring_camera_replay_matches_plain(scene3, interp, shading, smooth):
    """B2's coloring route with its camera chain (F_AEXP, the half vector
    and the gradient field's coordinates; none through the importance or
    the density) against the plain replay."""
    p, cam, feats, vol, lut, sign, grad, u8, imp = _mode_inputs(
        scene3, 30.0, 20.0, interp, "f32", shading, smooth, use_importance_coloring=True)
    p = p.replace(camera_grads=True)
    img = slab_march.march_cuda(feats, vol, lut, sign, p, grad, imp_perm=imp)
    g = torch.from_numpy(np.random.default_rng(3).uniform(-1, 1, (H, W, 4)).astype(np.float32)).to(img.device)
    want = slab.replay_slabs(feats, vol, lut, sign, p, img, g, grad, imp_perm=imp)
    got = slab_replay.replay_cuda(feats, vol, lut, sign, p, img, g, grad, imp_perm=imp)
    torch.cuda.synchronize()
    parity.check_close(want[0], got[0], "d_imp")
    if shading:
        parity.check_close(want[1], got[1], "d_grad")
    assert float(want[-1].abs().max()) > 0
    parity.check_close(want[-1], got[-1], "d_feats")


@pytest.mark.parametrize("gated", [False, True])
@pytest.mark.parametrize("interp,stream,shading,smooth", MODE_CASES)
def test_first_hit_march_matches_plain(scene3, interp, stream, shading, smooth, gated):
    """B1's first-hit bit for bit with the plain march, with shading,
    smoothing and the straight look-ahead gate."""
    p, cam, feats, vol, lut, sign, grad, u8, _ = _mode_inputs(scene3, 120.0, 10.0, interp, stream, shading, smooth,
                                                              use_opacity=False, use_importance_rendering=gated)
    gate = words = None
    if gated:
        cone_feats, levels = slab_march.lookahead_inputs(scene3, cam, p, H, W)
        words = lookahead.gate_cuda(feats, cone_feats, levels, sign, p.subtexel_bits)
        gate = lookahead.unpack_gate(words, vol.shape[0])
    img = slab_march.march_cuda(feats, vol, lut, sign, p, grad, u8=u8, gate=words)
    want = slab.march_slabs(feats, vol, lut, sign, p, grad, u8, gate=gate)
    torch.cuda.synchronize()
    assert torch.equal(img, want)
    assert not torch.equal(img, slab_march.march_cuda(feats, vol, lut, sign, p.replace(use_opacity=True), grad, u8=u8,
                                                      gate=words))


#: the replay's routes under the gate: (smoothing, stored, camera)
GATED_ROUTES = [(False, True, False), (False, False, False), (True, True, False), (True, False, False),
                (False, False, True), (True, False, True)]


@pytest.mark.parametrize("cone", [False, True], ids=["straight", "cone"])
@pytest.mark.parametrize("smooth,stored,camera", GATED_ROUTES)
@pytest.mark.parametrize("interp,shading", [("trilinear", False), ("nearest", True)])
def test_gated_march_and_replay_match_plain(scene3, interp, shading, smooth, stored, camera, cone):
    """B1 with the gate and its residual bit for bit, and B2 gated on every
    route (fused, unfused under smoothing, stored or re-sampled, camera)
    against the plain replay gated by the same bits."""
    p, cam, feats, vol, lut, sign, grad, u8, _ = _mode_inputs(
        scene3, 30.0, 20.0, interp, "f32" if camera else "u8", shading, smooth, use_importance_rendering=True,
        use_cone_importance_check=cone)
    p = p.replace(camera_grads=camera)
    cone_feats, levels = slab_march.lookahead_inputs(scene3, cam, p, H, W)
    words = lookahead.gate_cuda(feats, cone_feats, levels, sign, p.subtexel_bits)
    gate = lookahead.unpack_gate(words, vol.shape[0])
    assert bool(gate.any())
    if stored:
        img, dens = slab_march.march_cuda(feats, vol, lut, sign, p, grad, u8=u8, gate=words, emit_density=True)
        img_p, dens_p = slab.march_slabs(feats, vol, lut, sign, p, grad, u8, emit_density=True, gate=gate)
        torch.cuda.synchronize()
        assert torch.equal(img, img_p) and torch.equal(dens, dens_p)
    else:
        img, dens = slab_march.march_cuda(feats, vol, lut, sign, p, grad, u8=u8, gate=words), None
    g = torch.from_numpy(np.random.default_rng(3).uniform(-1, 1, (H, W, 4)).astype(np.float32)).to(img.device)
    want = slab.replay_slabs(feats, vol, lut, sign, p, img, g, grad, u8, dens, gate)
    before = slab_replay.LAUNCHES
    got = slab_replay.replay_cuda(feats, vol, lut, sign, p, img, g, grad, u8, dens, words)
    assert slab_replay.LAUNCHES == before + 1
    torch.cuda.synchronize()
    if smooth:
        assert torch.equal(want[1], got[1]), "step range"
        got = (slab.dense_dd(got[0], got[1]), *got[1:])
    parity.check_close(want[0], got[0], "d_vol" if not smooth else "dd")
    if shading and not smooth:
        parity.check_close(want[1], got[1], "d_grad")
    parity.check_lut_grad(want[2], got[2], lut, "d_lut")
    if camera:
        parity.check_close(want[-1], got[-1], "d_feats")
    ungated = slab.replay_slabs(feats, vol, lut, sign, p, slab.march_slabs(feats, vol, lut, sign, p, grad, u8), g,
                                grad, u8)
    assert not torch.equal(ungated[2], want[2]), "the gate changed nothing"


@pytest.mark.parametrize("mode", ["straight", "cone", "coloring", "coloring shaded"])
def test_new_modes_differentiable_renderer_counts_launches(scene3, device, mode):
    """The training step with look-ahead (B6 or B7, then B1 and B2 gated)
    and with coloring (B1 and B2 in their coloring modes) through
    ``make_renderer(..., differentiable=True)``: launch counts, and the
    image and the volume, LUT and importance gradients against the plain
    step's."""
    kw = dict(straight=dict(use_importance_rendering=True),
              cone=dict(use_importance_rendering=True, use_cone_importance_check=True),
              coloring=dict(use_importance_coloring=True, use_shading=False),
              **{"coloring shaded": dict(use_importance_coloring=True, use_shading=True)})[mode]
    p = RenderParams(interpolation="trilinear", raymarching_step_size=1.0 / SIDE, camera_grads=False, **kw)

    def step(backend):
        s = Scene(scene3.volume.clone().requires_grad_(True), scene3.importance.clone().requires_grad_(True),
                  scene3.tf_lut.clone().requires_grad_(True))
        cam = Camera(aspect=W / H, distance=1.3).orbit(30.0, 20.0, 0.0).matrices()
        img = make_renderer(s, p, H, W, backend=backend, device=device, differentiable=True)(cam)
        img.sum().backward()
        return img.detach(), s.volume.grad, s.tf_lut.grad, s.importance.grad

    def counts():
        return (slab_march.LAUNCHES, slab_replay.LAUNCHES, lookahead.STRAIGHT_LAUNCHES, lookahead.CONE_LAUNCHES)

    before = counts()
    got = step("slab_cuda")
    launched = tuple(a - b for a, b in zip(counts(), before))
    assert launched == (1, 1, int(mode == "straight"), int(mode == "cone"))
    want = step("slab")
    assert torch.equal(want[0], got[0])
    if mode.startswith("coloring"):
        assert float(got[3].abs().max()) > 0 and not bool(got[2].any())
        parity.check_close(want[3], got[3], "d_importance")
        if mode == "coloring shaded":
            parity.check_close(want[1], got[1], "d_volume")
        else:
            assert not bool(got[1].any())
    else:
        assert got[3] is None
        parity.check_close(want[1], got[1], "d_volume")
        parity.check_lut_grad(want[2], got[2], scene3.tf_lut, "d_lut")


# ----------------------------------------------------------------------
# The t-step renderers (backend "ray"): PyTorch ops, no kernel of their own
# ----------------------------------------------------------------------

TSTEP_MODES = {
    "base": dict(use_gaussian_smoothing=False),
    "first_hit": dict(use_gaussian_smoothing=False, use_opacity=False),
    "trilinear_gaussian": dict(interpolation="trilinear"),
    "straight": dict(use_gaussian_smoothing=False, use_importance_rendering=True, importance_check_ahead_steps=4),
    "cone": dict(use_gaussian_smoothing=False, use_importance_rendering=True, use_cone_importance_check=True,
                 importance_check_ahead_steps=4),
    "coloring": dict(use_gaussian_smoothing=False, use_importance_coloring=True),
}


@pytest.fixture(scope="module")
def teapot16():
    return Scene.synthetic("teapot", side=16)


@pytest.mark.parametrize("mode", list(TSTEP_MODES))
def test_ray_backend_on_the_card_matches_cpu(teapot16, device, mode):
    """``make_renderer(backend="ray")`` on the card against the same frame
    on the CPU, by the repo's rule; on the card ``fast`` equals ``golden``
    bit for bit."""
    from volym_tpu_torch.render import golden

    p = RenderParams(raymarching_step_size=0.05, **TSTEP_MODES[mode])
    cam = Camera(distance=1.1).orbit(30.0, 20.0, 0.0).matrices()
    got = make_renderer(teapot16, p, 24, 32, backend="ray", device=device)(cam)
    assert got.device.type == "cuda"
    assert torch.equal(got, golden.render(teapot16.to(device), cam.to(device), p, 24, 32))
    want = make_renderer(teapot16, p, 24, 32, backend="ray", device="cpu")(cam)
    assert float(want[..., :3].max()) > 0.1
    parity.check_close(want, got.cpu(), mode)


@pytest.mark.parametrize("mode", ["base", "trilinear_gaussian", "straight", "coloring"])
def test_ray_backend_gradients_on_the_card_match_cpu(teapot16, device, mode):
    """``diff.render`` on the card against the CPU: the image and the
    volume, importance, LUT and camera gradients (the scatters add in no
    fixed order on the card: held to the rule, not to bit equality)."""
    p = RenderParams(raymarching_step_size=0.05, adaptive_stepping=False,
                     **{**TSTEP_MODES[mode], "interpolation": "trilinear"})

    def step(dev):
        s = Scene(teapot16.volume.clone(), teapot16.importance.clone(), teapot16.tf_lut.clone()).to(dev)
        for leaf in (s.volume, s.importance, s.tf_lut):
            leaf.requires_grad_(True)
        cam = Camera(distance=1.1).orbit(30.0, 20.0, 0.0).matrices(device=dev)
        cam.inverse_view_proj.requires_grad_(True)
        cam.position.requires_grad_(True)
        img = make_renderer(s, p, 24, 32, backend="ray", device=dev, differentiable=True)(cam)
        (img * torch.linspace(0.5, 1.5, img.numel(), device=dev).reshape(img.shape)).sum().backward()
        return [img.detach().cpu()] + [t.grad.cpu() for t in (s.volume, s.importance, s.tf_lut,
                                                                cam.inverse_view_proj, cam.position)]

    want, got = step("cpu"), step(device)
    for name, a, b in zip(("image", "volume", "importance", "tf_lut", "inverse_view_proj", "position"), want, got):
        assert bool(torch.isfinite(b).all()), name
        if a.abs().max() > 0:
            parity.check_close(a, b, f"{mode} {name}")
        else:
            assert not bool(b.any()), name


def test_ray_backend_without_cuda_raises(monkeypatch):
    """``backend="ray"`` on a CUDA device raises where CUDA is missing: no
    silent fall back to the CPU (runs everywhere, CUDA patched away)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_renderer(Scene.synthetic("sphere", side=8), RenderParams(), 8, 8, backend="ray", device="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        make_renderer(Scene.synthetic("sphere", side=8), RenderParams(), 8, 8, backend="ray")


def test_force_sync_of_a_cuda_frame(scene, device):
    from volym_tpu_torch.bench import harness

    img = make_renderer(scene, RenderParams(), H, W, backend="slab_cuda", device=device)(Camera().matrices())
    for out in (img, (None, img), {"frame": img}):
        got = harness.force_sync(out)
        assert isinstance(got, float) and got == float(img[0, 0, 0])


SHARDED_MODES = {
    "base": dict(use_gaussian_smoothing=False),
    "smoothed shaded": dict(use_gaussian_smoothing=True, interpolation="trilinear"),
    "cone": dict(use_gaussian_smoothing=False, use_importance_rendering=True, use_cone_importance_check=True),
    "coloring": dict(use_importance_coloring=True),
}


@pytest.mark.parametrize("shards", [1, 4, 7])
@pytest.mark.parametrize("mode", list(SHARDED_MODES))
def test_sharded_slab_cuda_equals_single_device(scene3, device, mode, shards):
    """``render_sharded`` on virtual shards of the card equals the
    single-device ``slab_cuda`` frame bit for bit (7 shards: 320 rays a
    shard, not whole rows), with B1 launched once a shard (and B7 under
    the cone)."""
    from volym_tpu_torch.parallel import mesh as pmesh

    p = RenderParams(raymarching_step_size=1.0 / SIDE, **SHARDED_MODES[mode])
    cam = Camera(aspect=W / H, distance=1.3).orbit(30.0, 20.0, 0.0).matrices()
    want = make_renderer(scene3, p, H, W, backend="slab_cuda", device=device)(cam)
    before = (slab_march.LAUNCHES, lookahead.CONE_LAUNCHES)
    got = pmesh.render_sharded(scene3, cam, p, H, W, pmesh.make_mesh([device] * shards), backend="slab_cuda")
    launched = (slab_march.LAUNCHES - before[0], lookahead.CONE_LAUNCHES - before[1])
    assert launched == (shards, shards if mode == "cone" else 0)
    assert torch.equal(got, want)


@pytest.mark.parametrize("shards", [1, 4])
@pytest.mark.parametrize("mode", ["bench", "smoothed camera"])
def test_sharded_slab_cuda_train_step_matches_single_device(scene, device, mode, shards):
    """``make_train_step(backend="slab_cuda")`` against autograd through the
    single-device ``slab_cuda`` render, by the repo's rule."""
    from volym_tpu_torch.parallel import mesh as pmesh

    if mode == "bench":
        p = RenderParams(interpolation="trilinear", density_threshold=0.15, raymarching_step_size=1.0 / SIDE,
                         use_shading=False, use_gaussian_smoothing=False, camera_grads=False)
    else:
        p = RenderParams(interpolation="trilinear", raymarching_step_size=1.0 / SIDE, use_shading=False)
    cam = Camera(aspect=W / H, distance=1.3).orbit(30.0, 20.0, 0.0).matrices()
    target = make_renderer(scene, p, H, W, backend="slab_cuda", device=device)(cam) * 0.8
    loss, grads = pmesh.make_train_step(p, H, W, pmesh.make_mesh([device] * shards), backend="slab_cuda",
                                        camera_matrices=cam)(scene, cam, target)
    leaves = Scene(*(t.detach().clone().requires_grad_() for t in (scene.volume, scene.importance, scene.tf_lut)))
    fixed = p.replace(adaptive_stepping=False, u8_volume=False)
    ref = torch.mean((make_renderer(leaves, fixed, H, W, backend="slab_cuda", device=device,
                                    differentiable=True)(cam) - target) ** 2)
    ref.backward()
    np.testing.assert_allclose(float(loss), float(ref.detach()), rtol=1e-5)
    parity.check_close(leaves.volume.grad, grads.volume, f"{mode} {shards} d_volume")
    parity.check_lut_grad(leaves.tf_lut.grad, grads.tf_lut, scene.tf_lut, f"{mode} {shards} d_lut")
    assert float(grads.volume.abs().max()) > 0 and not bool(grads.importance.any())


def test_nccl_world_of_one(scene, device):
    """A one-rank NCCL group: the sharded frame gathers over NCCL and
    equals the single-device frame bit for bit; the step, its sums
    all-reduced over NCCL, equals the same shards' step without a group:
    the loss bit for bit, the gradients by the repo's rule, since B2 sums
    them by float atomics whose order varies from run to run
    (``chip_smoke.py`` phase 11 reruns one step and counts the runs whose
    gradients' bits differ); an all-reduce over the one rank returns its input bit for bit; the
    group goes down at the end.  Each check names itself when it fails."""
    from datetime import timedelta

    import torch.distributed as dist

    from volym_tpu_torch.parallel import launch
    from volym_tpu_torch.parallel import mesh as pmesh

    def differ(a, b):
        return f"max abs difference {float((a.double() - b.double()).abs().max()):.3e}"

    p = RenderParams(use_gaussian_smoothing=False, raymarching_step_size=1.0 / SIDE)
    cam = Camera(aspect=W / H, distance=1.3).orbit(30.0, 20.0, 0.0).matrices()
    local = pmesh.make_host_mesh([device] * 2)  # made before the group: no collective
    try:
        assert launch.maybe_initialize(True, device="cuda", timeout=timedelta(seconds=120), env={}), \
            "maybe_initialize brought no group up"
        assert dist.get_backend() == "nccl", dist.get_backend()
        assert launch.local_device().type == "cuda", launch.local_device()
        mesh = pmesh.make_host_mesh([device] * 2)
        assert mesh.distributed and mesh.shape == (1, 2) and not local.distributed, (mesh, local)
        want = make_renderer(scene, p, H, W, backend="slab_cuda", device=device)(cam)
        got = pmesh.render_sharded(scene, cam, p, H, W, mesh, backend="slab_cuda")
        assert torch.equal(got, want), f"the sharded frame over NCCL: {differ(got, want)}"
        target = want * 0.8
        (la, ga), (lb, gb) = (pmesh.make_train_step(p, H, W, m, backend="slab_cuda", camera_matrices=cam)(
            scene, cam, target) for m in (mesh, local))
        assert float(ga.volume.abs().max()) > 0, "no volume gradient"
        assert torch.equal(la, lb), f"the loss over NCCL against no group: {differ(la, lb)}"
        assert not bool(ga.importance.any()) and not bool(gb.importance.any()), "a nonzero d_importance"
        parity.check_close(gb.volume, ga.volume, "d_volume over NCCL against no group")
        parity.check_lut_grad(gb.tf_lut, ga.tf_lut, scene.tf_lut, "d_lut over NCCL against no group")
        summed = ga.volume.clone()
        dist.all_reduce(summed)
        assert torch.equal(summed, ga.volume), f"an all-reduce over one rank: {differ(summed, ga.volume)}"
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def test_viewer_frame_on_the_card(scene, device, tmp_path):
    """The viewer's default backend on the card, ``slab_cuda``: its /frame is
    the PNG of the renderer's frame, byte for byte."""
    import threading
    import urllib.request

    from volym_tpu_torch import io as vio
    from volym_tpu_torch import viewer

    p = RenderParams()
    srv = viewer.make_server(scene, p, H, W, port=0, screenshot_dir=str(tmp_path))
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        host, port = srv.server_address
        with urllib.request.urlopen(f"http://{host}:{port}/frame?h=30&v=20&dist=1.2", timeout=120) as r:
            got = r.read()
    finally:
        srv.shutdown()
        srv.server_close()
        t.join(timeout=30)
    q = {"h": ["30"], "v": ["20"], "dist": ["1.2"]}
    want = make_renderer(scene, p, H, W, backend="slab_cuda", device=device)(
        viewer.camera_from_query(q, W / H).matrices())
    assert got == vio.png_bytes(want)


def test_two_nccl_ranks_on_one_card_raise(device, tmp_path):
    """Two processes of one NCCL group on the same card: each fails with the
    port's own error (one rank a card), within the timeout."""
    import os
    import socket
    import subprocess
    import sys

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    code = ("import sys; from datetime import timedelta; from volym_tpu_torch.parallel import launch\n"
            "try:\n    launch.maybe_initialize(device='cuda', timeout=timedelta(seconds=60))\n"
            "except RuntimeError as e:\n    print(e); sys.exit(3)\n")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    procs = []
    for rank in range(2):
        env = {**os.environ, "PYTHONPATH": repo, "CUDA_VISIBLE_DEVICES": str(device.index or 0),
               "VOLYM_COORDINATOR": f"127.0.0.1:{port}", "VOLYM_NUM_PROCESSES": "2", "VOLYM_PROCESS_ID": str(rank)}
        procs.append(subprocess.Popen([sys.executable, "-c", code], env=env, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True))
    outs = []
    try:
        outs = [p.communicate(timeout=120)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, out in zip(procs, outs):
        assert p.returncode == 3 and "one rank a card" in out, out[-2000:]


# --- the per-ray and cone tables' kernels (csrc/ray_table.cu) ---------------

#: cameras whose rays have exactly zero direction components: through the
#: x = 1 and x = 0 faces (0/0 in the ray-box test: NaN entry and exit), on
#: the z = 1 face, straight down y (a vertical ray: the cone's right vector
#: is zero), inside the box, and along the x = y = 0 edge
EDGE_CAMERAS = [
    ((1.0, 0.5, 2.0), (1.0, 0.5, 0.0), (0.0, 1.0, 0.0)),
    ((0.0, 0.5, 2.0), (0.0, 0.5, 0.0), (0.0, 1.0, 0.0)),
    ((0.5, 0.5, 1.0), (0.5, 0.5, 0.0), (0.0, 1.0, 0.0)),
    ((0.5, 2.0, 0.5), (0.5, 0.0, 0.5), (0.0, 0.0, 1.0)),
    ((0.5, 0.5, 0.5), (0.5, 0.5, 2.0), (0.0, 1.0, 0.0)),
    ((0.0, 0.0, 2.0), (0.0, 0.0, 0.0), (0.0, 1.0, 0.0)),
]


def _same_bits(want, got):
    """torch.equal with NaN in the same places."""
    nan = torch.isnan(want)
    assert torch.equal(nan, torch.isnan(got)), "NaN in other places"
    assert torch.equal(want[~nan], got[~nan])


def _tables(cm, ndc, planes, major, sign, n_plane, cone):
    got = ray_table.table_cuda(cm.inverse_view_proj, cm.position, ndc, planes, major, sign, n_plane, cone=cone)
    want = slab_march.table_chain(cm, ndc, planes, major, sign, n_plane, cone)
    torch.cuda.synchronize()
    return want, got


@pytest.mark.parametrize("cone", [False, True])
@pytest.mark.parametrize("n_plane", [None, 48])
@pytest.mark.parametrize("hw", [(H, W), (7, 5), (768, 1024)])
@pytest.mark.parametrize("h,v", ORBITS)
def test_ray_tables_match_chain(device, h, v, hw, n_plane, cone):
    """Both kernels bit for bit with the chain of PyTorch ops on the card,
    on every march axis and sign (``ORBITS``), at 128 planes with a slice of
    ``planes`` rows and of 48 rows."""
    height, width = hw
    cm = Camera(aspect=width / height, distance=1.3).orbit(h, v, 0.0).matrices().to(device)
    major, sign = slab.dominant_axis(cm)
    _same_bits(*_tables(cm, rays_mod.pixel_ndc(height, width, device), 128, major, sign, n_plane, cone))


@pytest.mark.parametrize("cone", [False, True])
@pytest.mark.parametrize("hw", [(8, 8), (6, 10), (48, 64)])
@pytest.mark.parametrize("eye,target,up", EDGE_CAMERAS)
def test_ray_tables_edge_rays(device, eye, target, up, hw, cone):
    """Rays with exactly zero direction components, a vertical ray and an
    origin on a box face: bit for bit, NaN in the chain's places."""
    height, width = hw
    cm = camera_matrices(eye, target, up, math.radians(60.0), width / height, 0.01, 10.0, device=device)
    major, sign = slab.dominant_axis(cm)
    ndc = rays_mod.pixel_ndc(height, width, device)
    dirs = rays_mod.rays_from_ndc(cm, ndc)[1]
    want, got = _tables(cm, ndc, 64, major, sign, None, cone)
    _same_bits(want, got)
    if hw == (8, 8):  # the centre column's rays run in the plane of the faces
        assert bool((dirs == 0.0).any())
        if eye[0] in (0.0, 1.0) and not cone:
            assert bool(torch.isnan(want).any())


@pytest.mark.parametrize("cone", [False, True])
@pytest.mark.parametrize("n", [4, 7])
def test_ray_tables_of_shards(device, n, cone):
    """A shard's NDC rows, laid out as ``render_sharded`` lays them ((H/n,
    W) or (1, R/n)): the whole frame's columns, bit for bit."""
    from volym_tpu_torch.parallel.mesh import _shard_shape

    height, width = 36, 56  # 4 divides the rows, 7 only the rays
    cm = Camera(aspect=width / height, distance=1.3).orbit(120.0, 10.0, 0.0).matrices().to(device)
    major, sign = slab.dominant_axis(cm)
    ndc = rays_mod.pixel_ndc(height, width, device)
    frame = ray_table.table_cuda(cm.inverse_view_proj, cm.position, ndc, 128, major, sign, 64, cone=cone)
    per, shape = height * width // n, _shard_shape(height, width, n)
    assert shape == ((height // n, width) if n == 4 else (1, per))
    feats = slab_march._cone_features if cone else slab_march._features
    for k in range(n):
        rows = slice(k * per, (k + 1) * per)
        got = feats(cm, ndc[rows], shape, 128, major, sign, 64)
        torch.cuda.synchronize()
        _same_bits(frame[:, rows], got.reshape(frame.shape[0], per))


def _table_counts():
    return ray_table.LAUNCHES, ray_table.CONE_LAUNCHES


@pytest.mark.parametrize("cone", [False, True])
def test_renderer_counts_table_launches(scene3, device, cone):
    """A frame: one launch of the per-ray table's kernel and, with the cone
    look-ahead, one of the cone table's."""
    p = _lookahead_params("u8", cone)
    render = make_renderer(scene3, p, H, W, backend="slab_cuda", device=device)
    before = _table_counts()
    render(Camera(aspect=W / H, distance=1.3).orbit(30.0, 20.0, 0.0).matrices())
    assert _table_counts() == (before[0] + 1, before[1] + cone)


@pytest.mark.parametrize("camera_grads", [False, True])
def test_differentiable_renderer_counts_table_launches(scene, device, camera_grads):
    """A training step launches the per-ray table's kernel once, with
    camera gradients too: then through ``KernelTable``, whose backward
    carries the gradient to the camera."""
    p = RenderParams(use_gaussian_smoothing=False, camera_grads=camera_grads)
    vol = scene.volume.clone().requires_grad_(True)
    render = make_renderer(Scene(vol, scene.importance, scene.tf_lut), p, H, W, backend="slab_cuda", device=device,
                           differentiable=True)
    cm = Camera(aspect=W / H, distance=1.3).orbit(30.0, 20.0, 0.0).matrices().to(device)
    cm.inverse_view_proj.requires_grad_(True)
    cm.position.requires_grad_(True)
    before = _table_counts()
    render(cm).sum().backward()
    assert _table_counts() == (before[0] + 1, before[1])
    assert (cm.position.grad is not None) == camera_grads
    if camera_grads:
        assert bool(torch.isfinite(cm.position.grad).all() and torch.isfinite(cm.inverse_view_proj.grad).all())


@pytest.mark.parametrize("cone", [False, True])
@pytest.mark.parametrize("hw", [(H, W), (768, 1024)])
@pytest.mark.parametrize("h,v", ORBITS)
def test_kernel_table_gradients_match_chain(device, h, v, hw, cone):
    """Where the table carries camera gradients: the kernel's values in the
    forward (one launch, no chain), and the chain's gradients of the camera
    bit for bit in the backward."""
    height, width = hw
    cm = Camera(aspect=width / height, distance=1.3).orbit(h, v, 0.0).matrices().to(device)
    major, sign = slab.dominant_axis(cm)
    ndc = rays_mod.pixel_ndc(height, width, device)
    rows = slab.CONE_FEATURES if cone else slab.N_FEATURES
    d_table = torch.randn((rows, height * width), device=device, generator=torch.Generator(device).manual_seed(5))
    out = []
    for kernel in (False, True):
        ivp = cm.inverse_view_proj.clone().requires_grad_(True)
        pos = cm.position.clone().requires_grad_(True)
        cam = type(cm)(cm.view, cm.proj, ivp, pos)
        before = _table_counts()
        if kernel:
            table = slab_march._table(cam, ndc, 128, major, sign, 48, cone)
            assert _table_counts() == (before[0] + (not cone), before[1] + cone)
        else:
            table = slab_march.table_chain(cam, ndc, 128, major, sign, 48, cone)
        out.append((table.detach(), *torch.autograd.grad(table, (ivp, pos), d_table)))
    torch.cuda.synchronize()
    for want, got in zip(*out):
        _same_bits(want, got)


def test_ray_table_checks_inputs(device):
    cm = Camera().matrices().to(device)
    ndc = rays_mod.pixel_ndc(4, 6, device)
    ivp, pos = cm.inverse_view_proj, cm.position
    with pytest.raises(ValueError, match="float32"):
        ray_table.table_cuda(ivp.double(), pos, ndc, 64, 2, 1)
    with pytest.raises(ValueError, match="contiguous"):
        ray_table.table_cuda(ivp.t(), pos, ndc, 64, 2, 1)
    with pytest.raises(ValueError, match="on cpu"):
        ray_table.table_cuda(ivp, pos.cpu(), ndc, 64, 2, 1)
