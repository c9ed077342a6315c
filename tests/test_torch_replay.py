"""The plain replay backward of volym_tpu_torch and its contracts, on the CPU.

- The stored-density residual: the image is unchanged when it is emitted,
  and it holds exactly 0.0 off the steps the march samples.
- The replay from the residual and the re-sampling replay give the same
  bits (the port's counterpart of the TPU package's
  ``test_stored_density_backward_bitwise`` and
  ``test_u8_stored_density_backward_bitwise``), in every mode.
- The replay against torch autograd of the plain march on f32 planes
  (repo rule ``volym_tpu_torch.parity.check_close``).  The two differ only
  where a derivative convention does: at an integer TF coordinate and at an
  exact zero of a shading dot, which random trilinear samples do not hit.
- The device dispatch, the stored-density gate and the differentiable
  entry points.
"""

import numpy as np
import pytest
import torch

from volym_tpu_torch import Camera, RenderParams, Scene, parity
from volym_tpu_torch.ops import slab_march, slab_replay
from volym_tpu_torch.render import slab
from volym_tpu_torch.render.renderer import make_renderer
from volym_tpu_torch.render.slab import F_AEXP, F_ENTRY, F_EXIT, F_SIGNOK, N_FEATURES
from volym_tpu_torch.transfer_function import lut_sample

SIDE, H, W = 16, 24, 32
ORBITS = [(30.0, 20.0), (210.0, 20.0), (120.0, 10.0), (300.0, -10.0), (20.0, 70.0), (20.0, -70.0)]
MODES = [
    (interp, stream, shading)
    for interp in ("nearest", "trilinear")
    for stream in ("u8", "f32")
    for shading in (False, True)
]


@pytest.fixture(scope="module")
def scene():
    return Scene.synthetic("bonsai", side=SIDE, seed=2)


def params(interp, stream, shading):
    return RenderParams(
        use_gaussian_smoothing=False, interpolation=interp, use_shading=shading, u8_volume=True,
        camera_grads=False, raymarching_step_size=(1.0 if stream == "u8" else 2.0) / SIDE,
    )


def inputs(scene, p, h, v):
    cam = Camera(aspect=W / H, distance=1.3).orbit(h, v, 0.0).matrices()
    return slab_march.prepare(scene, cam, p, H, W)


def cotangent(seed=3):
    return torch.from_numpy(np.random.default_rng(seed).uniform(-1.0, 1.0, (H, W, 4)).astype(np.float32))


@pytest.mark.parametrize("interp,stream,shading", MODES)
@pytest.mark.parametrize("h,v", ORBITS)
def test_stored_and_resampled_replay_bitwise(scene, h, v, interp, stream, shading):
    p = params(interp, stream, shading)
    feats, vol, lut, sign, grad, u8 = inputs(scene, p, h, v)
    assert u8 == (stream == "u8")
    img = slab.march_slabs(feats, vol, lut, sign, p, grad, u8)
    img_e, dens = slab.march_slabs(feats, vol, lut, sign, p, grad, u8, emit_density=True)
    assert torch.equal(img, img_e), "emit_density changed the image"
    assert tuple(dens.shape) == ((vol.shape[0], 4, H, W) if shading else (vol.shape[0], H, W))
    g = cotangent()
    stored = slab.replay_slabs(feats, vol, lut, sign, p, img, g, grad, u8, dens)
    resampled = slab.replay_slabs(feats, vol, lut, sign, p, img, g, grad, u8)
    assert float(stored[0].abs().max()) > 0 and float(stored[2].abs().max()) > 0
    for name, a, b in zip(("d_vol", "d_grad", "d_lut"), stored, resampled):
        if a is None:
            assert b is None and not shading
            continue
        assert torch.equal(a, b), f"{name}: stored != re-sampled"


@pytest.mark.parametrize("interp,stream,shading", MODES)
def test_residual_is_zero_off_the_sampled_steps(scene, interp, stream, shading):
    """Rebuild the sampled-step mask independently (t-window, sign flag,
    alpha below the early-termination alpha before the step) and hold the
    residual to it: the sampled density on it, exactly 0.0 off it, and the
    gradient field only where the density also passes the threshold."""
    p = params(interp, stream, shading)
    feats, vol, lut, sign, grad, u8 = inputs(scene, p, 30.0, 20.0)
    _, dens = slab.march_slabs(feats, vol, lut, sign, p, grad, u8, emit_density=True)
    dens = dens.reshape(vol.shape[0], 4 if shading else 1, -1)
    f = feats.reshape(N_FEATURES, -1)
    n, nr, nc = vol.shape
    threshold, early_alpha, dscale = slab.march_knobs(p, u8)
    sample2d = slab._bilinear_slice if interp == "trilinear" else slab._nearest_slice
    acc_a = torch.zeros(f.shape[1])
    sampled = 0
    for j in range(n):
        k, t, rows_c, cols_c = slab._step_coords(f, j, n, nr, nc, sign, p.subtexel_bits)
        density = sample2d(vol[k], rows_c, cols_c)
        live = (f[F_SIGNOK] > 0.5) & (t >= f[F_ENTRY]) & (t < f[F_EXIT]) & (acc_a < early_alpha)
        assert torch.equal(dens[j, 0][live], density[live])
        assert torch.equal(dens[j, 0][~live], torch.zeros(int((~live).sum())))
        if shading:
            dense = live & (density >= threshold)
            assert bool((dens[j, 1:][:, ~dense] == 0.0).all())
            assert bool((dens[j, 1:][:, dense] != 0.0).any()) or not bool(dense.any())
        a = lut_sample(lut, density, dscale)[:, 3]
        alpha = 1.0 - torch.exp(f[F_AEXP] * torch.log(torch.clamp(1.0 - a, min=1e-37)))
        acc_a = acc_a + (1.0 - acc_a) * alpha * (live & (density >= threshold)).float()
        sampled += int(live.sum())
    assert 0 < sampled < n * f.shape[1]


@pytest.mark.parametrize("shading", [False, True])
@pytest.mark.parametrize("interp", ["nearest", "trilinear"])
@pytest.mark.parametrize("h,v", ORBITS[:3])
def test_replay_matches_autograd_of_the_plain_march(h, v, interp, shading):
    """On f32 planes of a random volume: d_vol, d_grad and d_lut of the
    replay against torch autograd through :func:`slab.march_slabs`."""
    rng = np.random.default_rng(11)
    n = SIDE
    vol = torch.from_numpy(rng.uniform(0.0, 0.6, (n, n, n)).astype(np.float32)).requires_grad_(True)
    lut_np = rng.uniform(0.0, 1.0, (256, 4)).astype(np.float32)
    lut_np[:, 3] *= 0.3
    lut = torch.from_numpy(lut_np).requires_grad_(True)
    grad = torch.from_numpy(rng.normal(0.0, 1.0, (3, n, n, n)).astype(np.float32)).requires_grad_(True)
    p = params(interp, "f32", shading).replace(u8_volume=False, raymarching_step_size=1.0 / SIDE)
    scene = Scene(volume=vol.detach(), importance=torch.zeros_like(vol), tf_lut=lut.detach())
    feats, _, _, sign, _, u8 = inputs(scene, p, h, v)
    assert not u8
    g = cotangent(5)
    img = slab.march_slabs(feats, vol, lut, sign, p, grad if shading else None)
    (img * g).sum().backward()
    d_vol, d_grad, d_lut = slab.replay_slabs(
        feats, vol.detach(), lut.detach(), sign, p, img.detach(), g, grad.detach() if shading else None
    )
    parity.check_close(vol.grad, d_vol, "d_vol")
    parity.check_close(lut.grad, d_lut, "d_lut")
    if shading:
        parity.check_close(grad.grad, d_grad, "d_grad")


def test_replay_dispatches_cpu_tensors_to_plain_version(scene):
    p = params("trilinear", "u8", False)
    feats, vol, lut, sign, grad, u8 = inputs(scene, p, 30.0, 20.0)
    img = slab.march_slabs(feats, vol, lut, sign, p, grad, u8)
    before = slab_replay.LAUNCHES
    got = slab_replay.replay(feats, vol, lut, sign, p, img, cotangent(), grad, u8)
    want = slab.replay_slabs(feats, vol, lut, sign, p, img, cotangent(), grad, u8)
    assert torch.equal(got[0], want[0]) and torch.equal(got[2], want[2]) and got[1] is None
    assert slab_replay.LAUNCHES == before
    with pytest.raises(ValueError, match="CUDA tensors"):
        slab_replay.replay_cuda(feats, vol, lut, sign, p, img, cotangent(), grad, u8)


def test_use_stored_density_budget():
    """The gate of slab_kernel._use_stored_density: stored unless the
    residual is strictly larger than 1536 MiB, never under camera
    cotangents."""
    bench = RenderParams(use_shading=False, camera_grads=False)
    shaded = bench.replace(use_shading=True)
    rays = 1024 * 768
    assert slab_replay.use_stored_density(bench, 256, rays)  # 768 MiB
    assert slab_replay.use_stored_density(shaded, 128, rays)  # exactly 1536 MiB
    assert not slab_replay.use_stored_density(shaded, 256, rays)  # 3 GiB
    assert not slab_replay.use_stored_density(bench.replace(camera_grads=True), 16, 64)


@pytest.mark.parametrize("interp,stream,shading", MODES)
def test_diff_march_stored_and_resampled_agree(scene, monkeypatch, interp, stream, shading):
    """``render_diff`` with the residual and with the re-sampling replay
    (budget 0) gives the same image and gradients, bit for bit."""
    p = params(interp, stream, shading)
    cam = Camera(aspect=W / H, distance=1.3).orbit(120.0, 10.0, 0.0).matrices()
    g = cotangent(7)

    def step():
        vol = scene.volume.clone().requires_grad_(True)
        lut = scene.tf_lut.clone().requires_grad_(True)
        img = slab_march.render_diff(Scene(vol, scene.importance, lut), cam, p, H, W)
        (img * g).sum().backward()
        return img.detach(), vol.grad, lut.grad

    stored = step()
    monkeypatch.setattr(slab_replay, "STORE_DENSITY_BUDGET_MB", 0)
    resampled = step()
    assert float(stored[1].abs().max()) > 0
    for a, b in zip(stored, resampled):
        assert torch.equal(a, b)


def test_renderer_differentiable_on_cpu(scene):
    p = params("trilinear", "u8", True)
    vol = scene.volume.clone().requires_grad_(True)
    lut = scene.tf_lut.clone().requires_grad_(True)
    s = Scene(vol, scene.importance, lut, scene.volume_u8)
    cam = Camera(aspect=W / H).orbit(40.0, 15.0, 0.0).matrices()
    render = make_renderer(s, p, H, W, backend="slab", device="cpu", differentiable=True)
    img = render(cam)
    assert img.requires_grad and tuple(img.shape) == (H, W, 4)
    img.sum().backward()
    assert float(vol.grad.abs().max()) > 0 and float(lut.grad.abs().max()) > 0
    want = slab.render(scene, cam, p, H, W)
    assert torch.equal(img.detach(), want)


@pytest.fixture(scope="module")
def opaque_end_grad():
    """d_lut of a render whose samples reach the LUT's opaque end (half the
    volume faint, half at 1, an alpha-1 top row) with ``aexp < 1`` (256
    planes, as the bench step takes), with that LUT."""
    rng = np.random.default_rng(13)
    side = 64
    vol = rng.integers(0, 40, (side, side, side)).astype(np.float32)
    vol[side // 2 :] = 255.0
    lut = rng.uniform(0.0, 1.0, (256, 4)).astype(np.float32)
    lut[:, 3] *= 0.5
    lut[-1, 3] = 1.0
    volume = torch.from_numpy(vol / np.float32(255.0))
    s = Scene(volume, torch.zeros_like(volume), torch.from_numpy(lut).requires_grad_(True))
    cam = Camera(aspect=W / H, distance=1.3).orbit(30.0, 20.0, 0.0).matrices()
    p = params("trilinear", "f32", False).replace(raymarching_step_size=1.0 / 256)
    slab.render_diff(s, cam, p, H, W).sum().backward()
    return s.tf_lut.grad.double(), torch.from_numpy(lut)


@pytest.mark.parametrize("mutation", ["none", "noise", "off_the_end_scaled", "off_the_end_zeroed", "opaque_end_off"])
def test_lut_grad_rule_holds_both_ends(opaque_end_grad, mutation):
    """The opaque end of d_lut dwarfs the other entries (1 - a floored at
    1e-37), so one scale would pass a gradient that lost them all:
    ``parity.check_lut_grad`` holds each group on its own scale."""
    d, lut = opaque_end_grad
    opaque = torch.from_numpy(parity.opaque_entries(lut))
    assert int(opaque.sum()) == 1 and float(d[opaque].abs().min()) > 1e6 * float(d[~opaque].abs().max())
    noise = torch.from_numpy(np.random.default_rng(4).normal(0.0, 1e-7, d.shape))
    bad = {
        "none": d,
        "noise": d * (1.0 + noise),
        "off_the_end_scaled": torch.where(opaque, d, d * 1.01),
        "off_the_end_zeroed": torch.where(opaque, d, 0.0),
        "opaque_end_off": torch.where(opaque, d * (1.0 + 1e-3), d),
    }[mutation]
    if mutation in ("none", "noise"):
        r, worst = parity.check_lut_grad(d, bad, lut, "d_lut")
        assert worst <= 2e-4 and r.scale == float(d[~opaque].abs().max())
        return
    if mutation != "opaque_end_off":
        parity.check_close(d, bad, "d_lut on one scale")  # blind to it
    with pytest.raises(AssertionError):
        parity.check_lut_grad(d, bad, lut, "d_lut")
