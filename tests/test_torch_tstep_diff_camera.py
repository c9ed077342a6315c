"""volym_tpu_torch.render.diff's camera gradient where the JAX package's
is NaN (C6: rays with an exactly zero direction component) against the
JAX replay behind the same guarded entry, under eager JAX."""

import jax
import jax.numpy as jnp
import numpy as np

from test_torch_tstep_diff import BASE, RES
from tstep_common import camera, check_grads, check_image, cotangent, jax_vjp, lit, params, port_vjp, sphere
from volym_tpu.render import diff as jdiff
from volym_tpu.render import rays as jrays
from volym_tpu_torch.render import diff


def jax_guarded_render(scene, m, params, height, width):
    """``volym_tpu.render.diff.render`` with the port's guarded entry
    (``diff.ray_box_intersection``) in place of ``rays.ray_box_intersection``."""
    params = params.replace(adaptive_stepping=False)
    origin, dirs = jrays.generate_rays(m, height, width)
    zero = dirs == 0.0
    safe = jnp.where(zero, 1.0, dirs)
    t1 = jnp.where(zero, jax.lax.stop_gradient((0.0 - origin[None, :]) / dirs), (0.0 - origin[None, :]) / safe)
    t2 = jnp.where(zero, jax.lax.stop_gradient((1.0 - origin[None, :]) / dirs), (1.0 - origin[None, :]) / safe)
    entry = jnp.maximum(jnp.max(jnp.minimum(t1, t2), axis=-1), 0.0)
    exit_ = jnp.maximum(jnp.min(jnp.maximum(t1, t2), axis=-1), 0.0)
    img = jdiff.march_fixed(params, scene.volume, scene.importance, scene.tf_lut, origin, dirs, entry,
                            jax.lax.stop_gradient(exit_), m.position)
    img = jnp.where((exit_ <= entry)[:, None], jnp.array([0.0, 0.0, 0.0, 1.0], jnp.float32), img)
    return img.reshape(height, width, 4)


def test_camera_gradient_finite_on_axis_aligned_rays():
    """orbit (0, 0): the rays of the middle row and column have exactly
    zero direction components; JAX's entry gradient is NaN there (C6), the
    port's finite and equal to JAX's behind the same guard."""
    sj, st = sphere()
    _, mj, mt = camera(0.0, 0.0)
    with jax.disable_jit():
        assert int((jrays.generate_rays(mj, RES, RES)[1] == 0).sum()) > 0
    pj, pt = params(**BASE)
    w = cotangent(RES)
    img_j, want = jax_vjp(jax_guarded_render, sj, mj, pj, w, RES)
    img_t, got = port_vjp(diff.render, st, mt, pt, w, RES)
    assert lit(img_j) > 0.1
    check_image(img_j, img_t, "axis-aligned image")
    assert np.abs(want["position"]).max() > 0
    check_grads(want, got, "axis-aligned")
