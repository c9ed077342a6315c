"""Importance coloring's backward against the JAX package's jnp golden:
``jax.grad`` of ``volym_tpu.render.slab.render_diff`` (eager, its replay
VJP through ``golden.importance_to_color`` and, under smoothing, the
stencil's VJP) with respect to the volume and the importance, beside the
port's ``render_diff`` on the CPU, on the scene and loss of
``test_torch_coloring_diff``, on resampled f32 planes (8: the eager golden
costs about a second a march step).  Tolerance: the repo's knife-edge
rule, on the image, d_importance and (shaded) d_volume.

One named difference: at importance 170/255, 1.5 * float32(170/255) rounds
to exactly 1.0, where the golden's ``jnp.minimum(1.5 imp, 1)`` passes 0.75
of d_r and the TPU kernel's ``where(1.5 imp < 1, 1.5, 0)`` (``slab_bwd_kernel
.py:704-711``), which the port follows, passes none (a nearest f32 case
measured 0.013 of 21.2 at one voxel).  The importance here therefore takes
171/255 for 170/255; ``test_torch_coloring_diff`` holds the port to the TPU
kernel on importance that includes 170/255.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import volym_tpu as vj
from tests.test_torch_coloring import H, SIDE, W, coloring_params
from tests.test_torch_coloring_diff import check_coloring_step, inputs  # noqa: F401
from tests.test_torch_diff import DISTANCE
from tests.test_torch_lookahead_diff import port_step
from volym_tpu.render import slab as jslab


@pytest.mark.parametrize("interp,shading,smooth,orbit", [("trilinear", True, True, (30.0, 20.0))])
def test_coloring_render_diff_matches_golden(inputs, interp, shading, smooth, orbit):  # noqa: F811
    vol, imp, lut, w = inputs
    tie = np.float32(170.0) / np.float32(255.0)
    assert np.float32(tie * np.float32(1.5)) == 1.0 and (imp == tie).any()
    imp = np.where(imp == tie, np.float32(171.0) / np.float32(255.0), imp).astype(np.float32)
    inputs = (vol, imp, lut, w)
    mj = vj.Camera(aspect=W / H, distance=DISTANCE).orbit(*orbit, 0.0).matrices()
    pj = coloring_params(interp, "f32", shading, smooth, camera_grads=False)
    assert jslab.resolve_planes(pj, SIDE) == SIDE // 2

    def loss(v, l, i):
        img = jslab.render_diff(vj.Scene(v, i, l), mj, pj, H, W)
        return jnp.sum(img * w), img

    with jax.disable_jit():
        (_, img), grads = jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(
            jnp.asarray(vol), jnp.asarray(lut), jnp.asarray(imp)
        )
    want = (np.asarray(img), *(np.asarray(g) for g in grads))
    check_coloring_step(want, port_step(inputs, mj, pj), shading, f"{interp} shading={shading} smoothing={smooth}")
