"""Camera gradients of volym_tpu_torch's differentiable slab render against
volym_tpu.

The same numpy volume, LUT and loss weights as ``test_torch_diff`` (made
from a seed) go through the port's ``render_diff`` on the CPU with
``camera_grads=True`` (the plain march, the plain replay with its camera
chain and, under smoothing with trilinear sampling, the plain rows' chain
``slab.feats_grad``; ``torch.autograd`` carries ``d_feats`` through the
per-ray table to the camera matrices) and through ``jax.grad`` of the jnp
golden ``volym_tpu.render.slab._render_diff_jit`` with respect to its
``CameraMatrices``, run eagerly (``jax.disable_jit``, see
``test_torch_march``).  The loss is ``sum(img * w)``.

- The gradients on ``inverse_view_proj`` and ``position`` are held to
  ``tests/test_slab_kernel_ci.py``'s tolerance for the TPU kernels' camera
  gradients, atol 5e-3 of the leaf's scale and rtol 5e-2, in every
  {nearest, trilinear} x {shaded, unshaded} x {smoothing off, on} case on
  resampled f32 planes (8 of 16: the eager golden re-traces each step's
  VJP), one view of each march sign; measured, they agree to ~6e-7 of the
  scale.  The nearest cases run here, the trilinear ones in
  ``test_torch_camera_trilinear`` (unsmoothed) and
  ``test_torch_camera_trilinear_smooth``.  ``view`` and ``proj`` get no
  gradient in either package (the march axis is chosen on the host): None
  in the port, zeros in JAX (``parity.check_camera_grad``).
- ``camera_grads=False`` leaves d_volume and d_lut bit for bit as with the
  flag on, and gives the camera no gradient.
- The forward render keeps the u8 stream and its image whatever
  ``camera_grads`` says; only the differentiable render with camera
  gradients marches f32 (``slab_march.u8_active``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import volym_tpu as vj
from tests.test_torch_diff import DISTANCE, H, SIDE, W, inputs  # noqa: F401
from volym_tpu.render import slab as jslab
from volym_tpu_torch import convert, parity
from volym_tpu_torch.ops import slab_march, slab_replay
from volym_tpu_torch.render import slab

LEAVES = ("view", "proj", "inverse_view_proj", "position")
SIGN_ORBITS = [(30.0, 20.0), (210.0, 20.0)]  # march sign +1 and -1
#: (interpolation, shading, smoothing, orbit): every mode once, each
#: setting of one factor on both march signs
CASES = [
    ("nearest", False, False, SIGN_ORBITS[0]), ("nearest", False, True, SIGN_ORBITS[1]),
    ("nearest", True, False, SIGN_ORBITS[1]), ("nearest", True, True, SIGN_ORBITS[0]),
    ("trilinear", False, False, SIGN_ORBITS[0]), ("trilinear", False, True, SIGN_ORBITS[1]),
    ("trilinear", True, False, SIGN_ORBITS[1]), ("trilinear", True, True, SIGN_ORBITS[0]),
]


def jax_params(interp, shading, smooth, **kw):
    """The eager golden costs about a second a march step, so the planes are
    few: 8, the least smoothing takes, in every case (eager JAX compiles
    each primitive at its first call on a shape, so one plane count keeps
    that cost to the first case)."""
    return vj.RenderParams(
        use_gaussian_smoothing=smooth, use_shading=shading, interpolation=interp, density_threshold=0.15,
        raymarching_step_size=2.0 / SIDE, **kw,
    )


def port_grads(vol, lut, w, mj, pj):
    """(image, d_volume, d_lut, {leaf: its gradient or None}) of the port."""
    st = convert.scene(vol, np.zeros_like(vol), lut)
    st.volume.requires_grad_(True)
    st.tf_lut.requires_grad_(True)
    cm = convert.camera_matrices_from_jax(mj)
    for name in LEAVES:
        getattr(cm, name).requires_grad_(True)
    img = slab_march.render_diff(st, cm, convert.render_params(pj), H, W)
    (img * torch.from_numpy(w)).sum().backward()
    return img.detach(), st.volume.grad, st.tf_lut.grad, {name: getattr(cm, name).grad for name in LEAVES}


def golden_case(inputs, interp, shading, smooth, orbit):  # noqa: F811
    vol, lut, w = inputs
    pj = jax_params(interp, shading, smooth)
    mj = vj.Camera(aspect=W / H, distance=DISTANCE).orbit(*orbit, 0.0).matrices()
    major, sign = jslab.dominant_axis(mj)
    scene = vj.Scene(jnp.asarray(vol), jnp.zeros_like(jnp.asarray(vol)), jnp.asarray(lut))

    def loss(mm):
        img = jslab._render_diff_jit(
            scene, mm, pj.slab_static(), H, W, major, sign, planes=jslab.resolve_planes(pj, SIDE)
        )
        return jnp.sum(img * w)

    with jax.disable_jit():
        want = jax.grad(loss)(mj)
    img, _, _, got = port_grads(vol, lut, w, mj, pj)
    assert float(img[..., 3].max()) > 0.5, "the frame is empty"
    assert np.abs(np.asarray(want.position)).max() > 0, "no camera gradient"
    want = {name: np.asarray(getattr(want, name)) for name in LEAVES}
    label = f"{interp} shading={shading} smoothing={smooth} view {(major, sign)}"
    for name in ("inverse_view_proj", "position"):
        a, b = want[name], got[name].numpy()
        np.testing.assert_allclose(b, a, atol=5e-3 * max(np.abs(a).max(), 1e-6), rtol=5e-2, err_msg=f"{label} {name}")
    assert got["view"] is None and got["proj"] is None
    parity.check_camera_grad(want, got, label)  # and the repo's rule: measured within ~6e-7 of the scale


@pytest.mark.parametrize("interp,shading,smooth,orbit", [c for c in CASES if c[0] == "nearest"])
def test_camera_grads_match_golden(inputs, interp, shading, smooth, orbit):  # noqa: F811
    golden_case(inputs, interp, shading, smooth, orbit)


@pytest.mark.parametrize("shading,smooth", [(False, True), (True, False)])
def test_camera_grads_flag(inputs, shading, smooth):  # noqa: F811
    """``camera_grads=False``: the same d_volume and d_lut bit for bit, and
    no camera gradient (``test_slab_kernel_ci.py::test_camera_grads_flag``)."""
    vol, lut, w = inputs
    mj = vj.Camera(aspect=W / H, distance=DISTANCE).orbit(120.0, 10.0, 0.0).matrices()
    on = port_grads(vol, lut, w, mj, jax_params("trilinear", shading, smooth))
    off = port_grads(vol, lut, w, mj, jax_params("trilinear", shading, smooth, camera_grads=False))
    assert on[3]["position"] is not None and float(on[3]["position"].abs().max()) > 0
    assert all(g is None for g in off[3].values())
    for a, b in zip(on[:3], off[:3]):
        assert torch.equal(a, b)


def test_forward_keeps_the_u8_stream(inputs):  # noqa: F811
    """A u8 configuration with the default ``camera_grads=True`` serves from
    the uint8 grid, the same image as with the flag off; the
    differentiable render with camera gradients marches f32 and re-samples
    in the replay (no residual)."""
    vol, lut, _ = inputs
    st = convert.scene(vol, np.zeros_like(vol), lut)
    cm = convert.camera_matrices_from_jax(vj.Camera(aspect=W / H, distance=DISTANCE).orbit(30.0, 20.0, 0.0).matrices())
    p = convert.render_params(vj.RenderParams(
        interpolation="trilinear", density_threshold=0.15, raymarching_step_size=1.0 / SIDE, u8_volume=True,
    ))
    assert p.camera_grads
    feats, vperm, *_, u8 = slab_march.prepare(st, cm, p, H, W)
    assert u8 and vperm.dtype == torch.uint8
    img = slab_march.render(st, cm, p, H, W)
    assert torch.equal(img, slab_march.render(st, cm, p.replace(camera_grads=False), H, W))
    assert not slab_march.u8_active(p, SIDE, SIDE) and slab_march.u8_active(p.replace(camera_grads=False), SIDE, SIDE)
    assert not slab_replay.use_stored_density(p, SIDE, H * W)
    with pytest.raises(ValueError, match="re-sampled"):
        slab.replay_slabs(feats, vperm.float(), st.tf_lut, 1, p, img, img, dens=torch.zeros(SIDE, H, W))
