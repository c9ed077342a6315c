"""The u8 forward of volym_tpu_torch renders the volume as it stands.

A scene built from uint8 data keeps the uint8 grid beside the float volume
and a record of which volume tensor, at which ``_version``, the grid was
made from (``Scene.u8_source``).  The u8 march streams the grid only while
that record matches ``scene.volume``; otherwise it derives the grid from
the volume, ``round(volume * 255)``, as the JAX package does on every frame
(``slab_kernel.py:1378-1386``).

Three scenes whose copy is not current, each held to the TPU forward
(``slab_kernel._render_pallas_jit`` under ``tests/pallas_emu.py``) on the
same volume by the repo rule (``parity.check_close``), at 16^3 with
``u8_volume=True`` on native planes, through the port's plain backend
``slab`` on the CPU: a volume edited in place, a ``dataclasses.replace``
scene with a new volume and the old copy, and a scene without a copy.
Then the record's own contract: a current copy is streamed as it is (no
rounding a frame), ``Scene.to`` and ``convert.scene`` keep the record, and
editing the copy itself makes it stale too.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import volym_tpu as vj
from tests.pallas_emu import emulate
from volym_tpu.ops import slab_kernel
from volym_tpu.render import slab as jslab
from volym_tpu_torch import RenderParams, Scene, convert, parity
from volym_tpu_torch.ops import slab_march
from volym_tpu_torch.render import slab
from volym_tpu_torch.render.renderer import make_renderer

SIDE, H, W = 16, 16, 24
#: the bench forward (trilinear, threshold .15, u8, unshaded) on 16 native
#: planes, and the CLI default's shading and smoothing on the same planes
CONFIGS = {
    "bench": dict(interpolation="trilinear", density_threshold=0.15, use_shading=False,
                  use_gaussian_smoothing=False),
    "shaded_smoothed": dict(interpolation="nearest", density_threshold=0.12, use_shading=True,
                            use_gaussian_smoothing=True),
}


def _params(config):
    return vj.RenderParams(u8_volume=True, raymarching_step_size=1.0 / SIDE, camera_grads=False, **CONFIGS[config])


def _camera():
    return vj.Camera(aspect=W / H, distance=1.2).orbit(30.0, 20.0, 0.0).matrices()


def _emulated_forward(volume: np.ndarray, lut: np.ndarray, pj, mj) -> np.ndarray:
    """The TPU forward of ``volume`` under the emulator: u8 on native
    planes, the grid derived from the volume by the JAX render itself."""
    sj = vj.Scene(jnp.asarray(volume), jnp.zeros_like(jnp.asarray(volume)), jnp.asarray(lut))
    major, sign = jslab.dominant_axis(mj)
    planes = jslab.resolve_planes(pj, SIDE)
    assert planes == SIDE
    with emulate(slab_kernel):
        return np.asarray(slab_kernel._render_pallas_jit.__wrapped__(
            sj, mj, pj.pallas_static(), H, W, major, sign, knobs=pj.knobs(), planes=planes))


def _scene(kind: str) -> Scene:
    """A scene whose uint8 copy is not the volume as it stands."""
    base = Scene.synthetic("bonsai", side=SIDE, seed=5)
    if kind == "edited_in_place":
        base.volume.mul_(0.5)
        return base
    if kind == "replaced_volume":
        return dataclasses.replace(base, volume=base.volume * 0.5)
    assert kind == "no_copy"
    return Scene(base.volume * 0.5, base.importance, base.tf_lut)


@pytest.mark.parametrize("config", sorted(CONFIGS))
@pytest.mark.parametrize("kind", ["edited_in_place", "replaced_volume", "no_copy"])
def test_u8_frame_of_a_scene_without_a_current_copy_matches_tpu_forward(kind, config):
    s = _scene(kind)
    assert s.current_volume_u8() is None
    pj, mj = _params(config), _camera()
    want = _emulated_forward(s.volume.numpy(), s.tf_lut.numpy(), pj, mj)
    cm = convert.camera_matrices_from_jax(mj)
    p = convert.render_params(pj)
    got = make_renderer(s, p, H, W, backend="slab", device="cpu")(cm)
    assert np.abs(want[..., 3]).max() > 0.5
    parity.check_close(want, got, f"{kind} {config}")
    # the stale copy would have rendered the volume before the edit
    stale = Scene.synthetic("bonsai", side=SIDE, seed=5)
    assert float((slab.render(stale, cm, p, H, W) - got).abs().max()) > 1e-2
    # and the grid the frame streamed is the volume's own
    _, vol_perm, _, _, _, u8 = slab_march.prepare(s, cm, p, H, W)
    assert u8
    major = slab.dominant_axis(cm)[0]
    assert torch.equal(vol_perm, slab.permute_volume(slab_march.quantize_u8(s.volume), major).contiguous())


def test_current_copy_is_streamed_as_it_is():
    s = Scene.synthetic("bonsai", side=SIDE, seed=5)
    assert s.current_volume_u8() is s.volume_u8
    assert slab_march.u8_grid(s) is s.volume_u8
    # the copy equals the derived grid, so the frame equals the emulated TPU forward
    pj, mj = _params("bench"), _camera()
    want = _emulated_forward(s.volume.numpy(), s.tf_lut.numpy(), pj, mj)
    got = slab.render(s, convert.camera_matrices_from_jax(mj), convert.render_params(pj), H, W)
    parity.check_close(want, got, "current copy")


def test_record_follows_the_tensors():
    s = Scene.synthetic("bonsai", side=SIDE, seed=5)
    moved = s.to("cpu")
    assert moved.current_volume_u8() is moved.volume_u8
    # convert.scene records its copy, and none for a volume that is not u8-representable
    c = convert.scene(s.volume.numpy(), s.importance.numpy(), s.tf_lut.numpy())
    assert c.current_volume_u8() is c.volume_u8 and torch.equal(c.volume_u8, s.volume_u8)
    noisy = convert.scene(s.volume.numpy() + np.float32(1e-3), s.importance.numpy(), s.tf_lut.numpy())
    assert noisy.volume_u8 is None and noisy.current_volume_u8() is None
    # a stale record stays stale through Scene.to
    s.volume.add_(0.0)
    assert s.current_volume_u8() is None and s.to("cpu").current_volume_u8() is None
    # an edit of the copy itself makes it stale too
    t = Scene.synthetic("bonsai", side=SIDE, seed=5)
    t.volume_u8[0, 0, 0] = 7
    assert t.current_volume_u8() is None
    assert torch.equal(slab_march.u8_grid(t), slab_march.quantize_u8(t.volume))


def test_quantize_u8_rounds_half_to_even_and_clamps():
    v = torch.tensor([0.5 / 255.0, 1.5 / 255.0, 2.5 / 255.0, -0.1, 1.2, 1.0], dtype=torch.float32)
    want = np.clip(np.round(v.numpy() * np.float32(255.0)), 0, 255).astype(np.uint8)
    assert torch.equal(slab_march.quantize_u8(v), torch.from_numpy(want))
    assert slab_march.quantize_u8(v).tolist()[-1] == 255
    # under u8_volume a scene without a copy renders, from its own volume
    s = Scene.synthetic("bonsai", side=SIDE, seed=5)
    bare = Scene(s.volume, s.importance, s.tf_lut)
    cm = convert.camera_matrices_from_jax(_camera())
    p = RenderParams(u8_volume=True, raymarching_step_size=1.0 / SIDE, use_gaussian_smoothing=False)
    assert torch.equal(slab.render(bare, cm, p, H, W), slab.render(s, cm, p, H, W))
