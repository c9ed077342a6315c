"""The port's rays and per-ray tables against eager JAX, bit for bit.

The ray directions, the ray-box entry and exit, the per-ray table
(``features_from_rays``, row by row), the cone look-ahead directions and
the cone table feed the subtexel snap and the look-ahead's compares,
where one ulp moves a texel or flips a gate bit.  So they are held to
``np.array_equal``, not to a tolerance, at every test orbit at 24x32 and
camera distance 1.3 and at 256x256 and distance 1.0.  The JAX side runs
eagerly (``jax.disable_jit``): jitted XLA contracts multiply-adds into
FMAs.  Two facts make the equality hold on the CPU:

- ``torch.sqrt`` on float32 CPU tensors is not correctly rounded (its
  vectorised kernel is picked by the CPU's capability); JAX's is.  The
  port roots through ``rays.sqrt_rn``.
- JAX's ``dirs @ origin`` (the table's cam.dir row) is a chain of fused
  multiply-adds; the port writes it out with ``rays.fma_rn``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import volym_tpu as vj
from volym_tpu.ops import slab_kernel
from volym_tpu.render import golden as jgolden
from volym_tpu.render import rays as jrays
from volym_tpu.render import slab as jslab
from volym_tpu_torch import convert
from volym_tpu_torch.ops import slab_march
from volym_tpu_torch.render import golden, rays, slab

ORBITS = [(30.0, 20.0), (210.0, 20.0), (120.0, 10.0), (300.0, -10.0), (20.0, 70.0), (20.0, -70.0)]
#: (height, width, camera distance): the test frames and a full-width one
FRAMES = [(24, 32, 1.3), (256, 256, 1.0)]
SIDE = 16


def bundles(h, v, frame):
    """((origin, dirs) of JAX, (origin, dirs) of the port, the JAX camera)."""
    height, width, distance = frame
    mj = vj.Camera(aspect=width / height, distance=distance).orbit(h, v, 0.0).matrices()
    with jax.disable_jit():
        oj, dj = jrays.generate_rays(mj, height, width)
    ot, dt = rays.generate_rays(convert.camera_matrices_from_jax(mj), height, width)
    return (np.asarray(oj), np.asarray(dj)), (ot, dt), mj


def same(want, got, name):
    want, got = np.asarray(want), got.numpy() if hasattr(got, "numpy") else np.asarray(got)
    assert want.shape == got.shape, name
    bad = int((want != got).sum())
    assert bad == 0, f"{name}: {bad} of {want.size} values differ"


@pytest.mark.parametrize("frame", FRAMES, ids=["24x32", "256x256"])
@pytest.mark.parametrize("h,v", ORBITS)
def test_rays_equal_jax(h, v, frame):
    (oj, dj), (ot, dt), _ = bundles(h, v, frame)
    same(oj, ot, "origin")
    same(dj, dt, "directions")
    with jax.disable_jit():
        ej, xj = jrays.ray_box_intersection(jnp.asarray(oj), jnp.asarray(dj))
    et, xt = rays.ray_box_intersection(ot, dt)
    same(ej, et, "entry")
    same(xj, xt, "exit")


@pytest.mark.parametrize("frame", FRAMES, ids=["24x32", "256x256"])
@pytest.mark.parametrize("h,v", ORBITS)
def test_feature_tables_equal_jax(h, v, frame):
    """The per-ray table row by row, native and resampled planes, and the
    cone table direction by direction (the TPU pads each direction to 8
    rows; the port's stride is 7)."""
    (oj, dj), (ot, dt), mj = bundles(h, v, frame)
    major, sign = jslab.dominant_axis(mj)
    layout = jslab._AXIS_LAYOUT[major]
    et, xt = rays.ray_box_intersection(ot, dt)
    for planes in (SIDE, SIDE // 2):
        with jax.disable_jit():
            ej, xj = jrays.ray_box_intersection(jnp.asarray(oj), jnp.asarray(dj))
            fj = np.asarray(slab_kernel.features_from_rays(
                jnp.asarray(oj), jnp.asarray(dj), ej, xj, planes, major, sign, layout, n_plane=SIDE))
            cj = np.asarray(slab_kernel.cone_features_from_rays(
                jnp.asarray(oj), jnp.asarray(dj), planes, major, sign, layout, n_plane=SIDE))
        ft = slab_march.features_from_rays(ot, dt, et, xt, planes, major, sign, n_plane=SIDE)
        assert ft.shape[0] == slab.N_FEATURES == slab_kernel.F_C2 + 1
        for row in range(slab.N_FEATURES):
            same(fj[row], ft[row], f"planes {planes} feature row {row}")
        ct = slab_march.cone_features_from_rays(ot, dt, planes, major, sign, n_plane=SIDE)
        for c in range(golden.CONE_SAMPLES):
            for i in range(slab.CF_STRIDE):
                same(cj[c * slab_kernel.CF_STRIDE + i], ct[c * slab.CF_STRIDE + i], f"planes {planes} cone {c} row {i}")


@pytest.mark.parametrize("frame", FRAMES, ids=["24x32", "256x256"])
@pytest.mark.parametrize("h,v", ORBITS)
def test_cone_directions_equal_jax(h, v, frame):
    (_, dj), (_, dt), _ = bundles(h, v, frame)
    with jax.disable_jit():
        want = jgolden.cone_directions(jnp.asarray(dj))
    same(want, golden.cone_directions(dt), "cone directions")


def test_norm_equals_jnp_linalg_norm():
    rng = np.random.default_rng(11)
    v = (rng.standard_normal((200_000, 3)) * 10.0 ** rng.uniform(-3, 3, (200_000, 1))).astype(np.float32)
    with jax.disable_jit():
        want = jnp.linalg.norm(jnp.asarray(v), axis=-1, keepdims=True)
    same(want, rays.norm3(torch.from_numpy(v)), "norm")


def test_sqrt_rn_is_correctly_rounded():
    x = np.random.default_rng(12).uniform(0.0, 8.0, 1 << 20).astype(np.float32)
    same(np.sqrt(x), rays.sqrt_rn(torch.from_numpy(x)), "sqrt")


def test_fma_rn_equals_jax_dot():
    """``dirs @ origin`` in eager JAX against the port's FMA chain, on
    random vectors over six decades, so that sums cancel and round at every
    position."""
    rng = np.random.default_rng(13)
    d = (rng.standard_normal((200_000, 3)) * 10.0 ** rng.uniform(-3, 3, (200_000, 3))).astype(np.float32)
    o = rng.standard_normal(3).astype(np.float32)
    with jax.disable_jit():
        want = jnp.asarray(d) @ jnp.asarray(o)
    dt, ot = torch.from_numpy(d), torch.from_numpy(o)
    got = rays.fma_rn(dt[:, 2], ot[2], rays.fma_rn(dt[:, 1], ot[1], dt[:, 0] * ot[0]))
    same(want, got, "dirs @ origin")
    # a sum whose float64 rounding lands exactly halfway between two float32
    # neighbours: a * b = 2^-24 (1 + 4688 * 2^-46), so a * b + 1 lies just
    # above 1 + 2^-24, rounds to 1 + 2^-23, and float64 alone rounds it to 1
    a = torch.tensor([(1.0 + 2896 * 2.0**-23) * 2.0**-12], dtype=torch.float32)
    b = torch.tensor([(1.0 - 2895 * 2.0**-23) * 2.0**-12], dtype=torch.float32)
    c = torch.ones(1, dtype=torch.float32)
    assert (a.double() * b.double() + c.double()).float().item() == 1.0
    assert rays.fma_rn(a, b, c).item() == 1.0 + 2.0**-23
    assert rays.fma_rn(-a, b, -c).item() == -(1.0 + 2.0**-23)
