"""The unsmoothed trilinear cases of ``test_torch_camera`` (the camera
gradients of volym_tpu_torch's ``render_diff`` against ``jax.grad`` of
volym_tpu's jnp golden), where the coordinate chain of every sample runs:
the density's and, shaded, the gradient field's.

On a view where some ray's direction has an exactly zero component, the
port's camera gradient is finite and agrees with the golden's march
(``slab.march_slabs_diff``) composed here with ``stop_gradient`` on the
ray's entry and exit: the golden as it stands gives NaN there, because its
zero cotangent for the entry (a mask) meets the ray-box division's 0 * inf
(ROADMAP §C)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import volym_tpu as vj
from tests.test_torch_camera import CASES, SIDE, golden_case, jax_params
from tests.test_torch_diff import DISTANCE, H, W, inputs  # noqa: F401
from volym_tpu.render import rays as jrays
from volym_tpu.render import slab as jslab
from volym_tpu_torch import convert
from volym_tpu_torch.ops import slab_march


@pytest.mark.parametrize("interp,shading,smooth,orbit", [c for c in CASES if c[0] == "trilinear" and not c[2]])
def test_camera_grads_match_golden(inputs, interp, shading, smooth, orbit):  # noqa: F811
    golden_case(inputs, interp, shading, smooth, orbit)


def test_camera_grads_finite_on_axis_aligned_rays(inputs):  # noqa: F811
    """The rays of orbit (0, 20): 24 direction components are exactly 0."""
    vol, lut, w = inputs
    pj = jax_params("trilinear", False, False)
    mj = vj.Camera(aspect=W / H, distance=DISTANCE).orbit(0.0, 20.0, 0.0).matrices()
    major, sign = jslab.dominant_axis(mj)
    scene = vj.Scene(jnp.asarray(vol), jnp.zeros_like(jnp.asarray(vol)), jnp.asarray(lut))
    planes = jslab.resolve_planes(pj, SIDE)

    def loss(mm):
        vol_perm = jslab.slab_resample(jslab.permute_volume(scene.volume, major), planes)
        imp_perm = jslab.slab_resample_nearest(jslab.permute_volume(scene.importance, major), planes)
        origin, dirs = jrays.generate_rays(mm, H, W)
        entry, exit_ = jrays.ray_box_intersection(origin, dirs)
        img = jslab.march_slabs_diff(pj.slab_static(), major, sign, vol_perm, imp_perm, scene.tf_lut, origin, dirs,
                                     jax.lax.stop_gradient(entry), jax.lax.stop_gradient(exit_))
        img = jnp.where((exit_ <= entry)[:, None], jnp.array([0.0, 0.0, 0.0, 1.0], jnp.float32), img)
        return jnp.sum(img.reshape(H, W, 4) * w)

    with jax.disable_jit():
        assert int((jrays.generate_rays(mj, H, W)[1] == 0).sum()) > 0
        want = jax.grad(loss)(mj)
    st = convert.scene(vol, np.zeros_like(vol), lut)
    cm = convert.camera_matrices_from_jax(mj)
    cm.inverse_view_proj.requires_grad_(True)
    cm.position.requires_grad_(True)
    (slab_march.render_diff(st, cm, convert.render_params(pj), H, W) * torch.from_numpy(w)).sum().backward()
    for name in ("inverse_view_proj", "position"):
        a, b = np.asarray(getattr(want, name)), getattr(cm, name).grad.numpy()
        assert np.isfinite(a).all() and np.isfinite(b).all() and np.abs(a).max() > 0
        np.testing.assert_allclose(b, a, atol=5e-3 * np.abs(a).max(), rtol=5e-2, err_msg=name)
