"""The differentiable slab render of volym_tpu_torch under Gaussian smoothing
against volym_tpu, and the contracts of its backward.

The same numpy volume, LUT and loss weights as ``test_torch_diff`` go
through the port's ``render_diff`` on the CPU (the plain march, the plain
replay's per-step cotangents, the stencil's transpose and the plain
scatter) and through two JAX references, run eagerly (``jax.disable_jit``);
the loss is ``sum(img * w)``, and the image, d_volume and d_lut are held to
the repo's knife-edge rule (``volym_tpu_torch.parity.check_close``).

- The TPU kernels: ``slab_kernel._render_pallas_diff_jit`` under the repo's
  Pallas emulator (``tests/pallas_emu.py``).  Under smoothing its backward
  cannot fuse: the replay ``_replay_kernel`` writes the per-step
  cotangents, ``_smooth_dd_transpose`` folds them, and ``_voxel_grad_kernel``
  (unshaded) or ``_voxel_grad_shaded_kernel`` (shaded) scatter them.  The
  bench and CLI-default configurations, cut to 16^3, are held as in
  ``test_torch_diff`` (the CLI default on resampled planes to bulk 1e-3 and
  edge share 5e-3, the measured exception named there: the emulated TPU
  kernel departs from its own jnp golden on resampled planes).
- The backward's contracts on the CPU: the replay from the residual and
  re-sampled give the same bits, its per-step cotangents are 0.0 where
  nothing composites, ``render_diff`` agrees with itself on both replay
  routes bit for bit, and the replay + transpose + scatter agree with torch
  autograd through the plain smoothed march.

The jnp golden's ``render_diff`` is held in ``test_torch_smooth_golden``
and ``test_torch_smooth_64``.
"""

import jax
import numpy as np
import pytest
import torch

import volym_tpu as vj
from tests.pallas_emu import emulate
from tests.test_torch_diff import DISTANCE, H, KERNEL_RULE, SIDE, W, check, inputs, jax_step, port_step  # noqa: F401
from volym_tpu.ops import slab_bwd_kernel, slab_kernel
from volym_tpu.render import slab as jslab
from volym_tpu_torch import Camera, RenderParams, Scene
from volym_tpu_torch.ops import slab_march, slab_replay, voxel_grad
from volym_tpu_torch.render import slab

ORBITS = [(30.0, 20.0), (210.0, 20.0), (120.0, 10.0), (300.0, -10.0), (20.0, 70.0), (20.0, -70.0)]
#: the bench step and the CLI default, with smoothing, cut to 16^3
CONFIGS = {
    "bench": dict(interpolation="trilinear", density_threshold=0.15, raymarching_step_size=1.0 / SIDE, use_shading=False),
    "cli": dict(interpolation="nearest", density_threshold=0.12, raymarching_step_size=2.0 / SIDE, use_shading=True),
}


@pytest.mark.parametrize("config", sorted(CONFIGS))
@pytest.mark.parametrize("h,v", ORBITS[:3])
def test_smoothed_render_diff_matches_tpu_kernels(inputs, config, h, v):
    vol, lut, w = inputs
    pj = vj.RenderParams(use_gaussian_smoothing=True, camera_grads=False, u8_volume=True, **CONFIGS[config])
    mj = vj.Camera(aspect=W / H, distance=DISTANCE).orbit(h, v, 0.0).matrices()
    major, sign = jslab.dominant_axis(mj)
    planes = jslab.resolve_planes(pj, SIDE)
    pk = pj if planes == SIDE else pj.replace(u8_volume=False)

    def render(v_, l_):
        scene = vj.Scene(v_, jax.numpy.zeros_like(v_), l_)
        return slab_kernel._render_pallas_diff_jit.__wrapped__(
            scene, mj, pk.pallas_static(), H, W, major, sign, knobs=pk.knobs(), planes=planes
        )

    with emulate(slab_kernel, slab_bwd_kernel):
        want = jax_step(render, vol, lut, w)
    bulk, edge_frac = KERNEL_RULE[config]
    check(want, port_step(vol, lut, w, mj, pj), f"{config} view {(major, sign)}", bulk, edge_frac)


def _params(interp, stream, shading):
    return RenderParams(
        use_gaussian_smoothing=True, interpolation=interp, use_shading=shading, u8_volume=True, camera_grads=False,
        raymarching_step_size=(1.0 if stream == "u8" else 2.0) / SIDE,
    )


MODES = [(i, s, sh) for i in ("nearest", "trilinear") for s in ("u8", "f32") for sh in (False, True)]


@pytest.fixture(scope="module")
def scene():
    return Scene.synthetic("bonsai", side=SIDE, seed=2)


@pytest.mark.parametrize("interp,stream,shading", MODES)
def test_smoothed_replay_stored_and_resampled_bitwise(scene, interp, stream, shading):
    """The unfused replay from the residual (the smoothed density, and the
    gradient-field samples when shaded) and re-sampled through the stencil
    give the same bits; ``dd`` is 0.0 wherever the step composites nothing,
    and the residual's row 0 is the smoothed density on the sampled steps."""
    p = _params(interp, stream, shading)
    cam = Camera(aspect=W / H, distance=1.3).orbit(30.0, 20.0, 0.0).matrices()
    feats, vol, lut, sign, grad, u8 = slab_march.prepare(scene, cam, p, H, W)
    img, dens = slab.march_slabs(feats, vol, lut, sign, p, grad, u8, emit_density=True)
    assert torch.equal(img, slab.march_slabs(feats, vol, lut, sign, p, grad, u8))
    g = torch.from_numpy(np.random.default_rng(3).uniform(-1, 1, (H, W, 4)).astype(np.float32))
    dd_s, steps_s, lut_s = slab.replay_slabs(feats, vol, lut, sign, p, img, g, grad, u8, dens)
    dd_r, steps_r, lut_r = slab.replay_slabs(feats, vol, lut, sign, p, img, g, grad, u8)
    n = vol.shape[0]
    assert tuple(dd_s.shape) == ((n, 4, H, W) if shading else (n, H, W))
    assert torch.equal(dd_s, dd_r) and torch.equal(lut_s, lut_r) and torch.equal(steps_s, steps_r)
    assert float(dd_s.abs().max()) > 0
    smooth = slab.smoothed_densities(feats, vol, sign, p)
    d0 = dens[:, 0] if shading else dens
    sampled = d0 != 0.0
    assert torch.equal(d0[sampled], smooth[sampled])
    threshold = slab.march_knobs(p, u8)[0]
    silent = ~(sampled & (d0 >= threshold))
    assert bool(((dd_s[:, 0] if shading else dd_s)[silent] == 0.0).all())


@pytest.mark.parametrize("interp,stream,shading", MODES[::3])
def test_smoothed_diff_stored_and_resampled_agree(scene, monkeypatch, interp, stream, shading):
    """``render_diff`` with the residual and with the re-sampling replay
    (budget 0) gives the same image and gradients, bit for bit."""
    p = _params(interp, stream, shading)
    cam = Camera(aspect=W / H, distance=1.3).orbit(120.0, 10.0, 0.0).matrices()
    g = torch.from_numpy(np.random.default_rng(7).uniform(-1, 1, (H, W, 4)).astype(np.float32))

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


@pytest.mark.parametrize("interp,side", [("trilinear", SIDE), ("nearest", 64)])
def test_smoothed_backward_matches_autograd_of_the_plain_march(interp, side):
    """On f32 planes of a random volume the replay + transpose + scatter
    against torch autograd through the plain smoothed march: trilinear at
    16 planes, and nearest at 64, where the box taps reach rows +-1."""
    from volym_tpu_torch import parity

    rng = np.random.default_rng(12)
    vol = torch.from_numpy(rng.uniform(0.0, 0.6, (side,) * 3).astype(np.float32))
    lut_np = rng.uniform(0.0, 1.0, (256, 4)).astype(np.float32)
    lut_np[:, 3] *= 0.3
    lut = torch.from_numpy(lut_np).requires_grad_(True)
    p = _params(interp, "f32", False).replace(u8_volume=False, raymarching_step_size=1.0 / side)
    s = Scene(volume=vol, importance=torch.zeros_like(vol), tf_lut=lut.detach())
    cam = Camera(aspect=W / H, distance=1.3).orbit(30.0, 20.0, 0.0).matrices()
    feats, vol_perm, _, sign, _, _ = slab_march.prepare(s, cam, p, H, W)
    vp = vol_perm.clone().requires_grad_(True)
    g = torch.from_numpy(rng.uniform(-1.0, 1.0, (H, W, 4)).astype(np.float32))
    img = slab.march_slabs(feats, vp, lut, sign, p)
    (img * g).sum().backward()
    dd, steps, d_lut = slab.replay_slabs(feats, vol_perm, lut.detach(), sign, p, img.detach(), g)
    d_vp, _, _ = slab_march.smooth_backward(feats, dd, steps, vol_perm, sign, p, slab.smooth_voxel_grad,
                                            slab.feats_grad)
    parity.check_close(vp.grad, d_vp, "d_vol")
    parity.check_close(lut.grad, d_lut, "d_lut")


def test_scatter_dispatches_cpu_tensors_to_plain_version(scene):
    p = _params("trilinear", "u8", True)
    cam = Camera(aspect=W / H, distance=1.3).orbit(30.0, 20.0, 0.0).matrices()
    feats, vol, *_ = slab_march.prepare(scene, cam, p, H, W)
    dd = torch.from_numpy(np.random.default_rng(1).normal(size=(vol.shape[0], 4, H, W)).astype(np.float32))
    before = (voxel_grad.LAUNCHES, voxel_grad.SHADED_LAUNCHES)
    got = voxel_grad.scatter(feats, dd, vol.shape, 1, p)
    want = slab.voxel_grad(feats, dd, vol.shape, 1, p)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert (voxel_grad.LAUNCHES, voxel_grad.SHADED_LAUNCHES) == before
    with pytest.raises(ValueError, match="CUDA tensors"):
        voxel_grad.scatter_cuda(feats, dd, vol.shape, 1, p)


def test_render_diff_still_refuses_camera_gradients_and_lookahead(scene):
    """Camera gradients run with smoothing (the default ``RenderParams()``),
    through B5's plain version; look-ahead is still refused."""
    cam = Camera().orbit(30.0, 20.0, 0.0).matrices()
    cam.position.requires_grad_(True)
    slab_march.render_diff(scene, cam, RenderParams(interpolation="trilinear"), 8, 8).sum().backward()
    assert float(cam.position.grad.abs().max()) > 0
    with pytest.raises(NotImplementedError, match="look-ahead"):
        slab_march.render_diff(scene, cam, RenderParams(camera_grads=False, use_importance_rendering=True), 8, 8)
