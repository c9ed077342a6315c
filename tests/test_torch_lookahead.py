"""The port's importance look-ahead gate against volym_tpu's TPU gate kernels.

``volym_tpu.ops.lookahead_kernel.lookahead_call`` (straight ``_straight_kernel``
and cone ``_cone_kernel``) runs under the repo's Pallas emulator
(``tests/pallas_emu.py``), on the JAX package's own per-ray and cone tables,
computed eagerly (``jax.disable_jit``); ``slab_kernel._unchunk_tiled`` undoes
the TPU's ray layout.  The port's plain gate
(``volym_tpu_torch.render.slab.lookahead_gate``) runs on its own tables.
Both get the same numpy volume and importance (made from a seed) through
``volym_tpu_torch.convert``.  The gate planes must be equal bit for bit, at
every (major axis, sign) view, straight and cone, on native and resampled
planes, on a scene with importance at all three levels (so that
"important ahead but not opaque" occurs) and on the 16^3 teapot stand-in.
No (step, ray) is exempt.
"""

import re
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import chip_smoke
import volym_tpu as vj
from tests.pallas_emu import emulate
from volym_tpu.ops import lookahead_kernel, slab_kernel
from volym_tpu.render import golden as jgolden
from volym_tpu.render import slab as jslab
from volym_tpu_torch import assets, convert, parity
from volym_tpu_torch.ops import lookahead, slab_march
from volym_tpu_torch.render import golden, slab

SIDE, H, W = 16, 24, 32
ORBITS = [(30.0, 20.0), (210.0, 20.0), (120.0, 10.0), (300.0, -10.0), (20.0, 70.0), (20.0, -70.0)]
#: native (16 planes) and resampled (step 1/8 -> 8 planes)
STEPS = [1.0 / SIDE, 2.0 / SIDE]
CSRC = Path(__file__).resolve().parents[1] / "volym_tpu_torch" / "ops" / "csrc"


def three_level_scene(side=SIDE):
    """The scene ``chip_smoke.py`` holds the gate kernels on, cut to
    ``side``: importance at all three look-ahead levels in dense shells."""
    return chip_smoke.three_level_scene(side)


def teapot_scene(side=SIDE):
    vol, labels, infos = assets.synthetic_teapot_segments(side)
    imp = assets.map_segments_to_importance(labels, infos)
    lut = vj.Scene.synthetic("sphere", side=8).tf_lut
    return assets.normalize_volume(vol), assets.normalize_volume(imp), np.asarray(lut)


def tpu_gate(arrays, mj, pj):
    """The emulated TPU gate -> (N, H, W) bool, in march order."""
    vol, imp, lut = arrays
    sj = vj.Scene(volume=vol, importance=imp, tf_lut=lut)
    major, sign = jslab.dominant_axis(mj)
    layout = jslab._AXIS_LAYOUT[major]
    planes = jslab.resolve_planes(pj, SIDE)
    with jax.disable_jit():
        imp_perm = jslab.slab_resample_nearest(jslab.permute_volume(sj.importance, major), planes)
        feats, _, r = slab_kernel._chunked_feats(mj, H, W, planes, major, sign, layout, n_plane=SIDE)
        cone = None
        if pj.use_cone_importance_check:
            cone = slab_kernel._chunk_rays(
                slab_kernel._pack_cone_features(mj, H, W, planes, major, sign, layout, n_plane=SIDE), H, W
            )
        with emulate(slab_kernel, lookahead_kernel):
            ahead = lookahead_kernel.lookahead_call(sign, imp_perm, feats, cone, 0, subtexel=pj.subtexel_bits)
        plane = np.asarray(slab_kernel._unchunk_tiled(ahead[:, :, 0, :], r, H, W))
    return plane.T.reshape(planes, H, W) > 0.5


def port_gate(arrays, mj, pj):
    """The port's plain gate and its level grid."""
    st = convert.scene(*arrays)
    mt, pt = convert.camera_matrices_from_jax(mj), convert.render_params(pj)
    feats, _, _, sign, _, _ = slab_march.prepare(st, mt, pt, H, W)
    cone, levels = slab_march.lookahead_inputs(st, mt, pt, H, W)
    return slab.lookahead_gate(feats, cone, levels, sign, pt.subtexel_bits), (feats, cone, levels, sign)


def params(cone, step):
    return vj.RenderParams(
        use_gaussian_smoothing=False, use_importance_rendering=True, use_cone_importance_check=cone,
        raymarching_step_size=step,
    )


@pytest.mark.parametrize("step", STEPS)
@pytest.mark.parametrize("cone", [False, True], ids=["straight", "cone"])
@pytest.mark.parametrize("h,v", ORBITS)
def test_gate_matches_tpu_kernel(h, v, cone, step):
    arrays = three_level_scene()
    mj = vj.Camera(aspect=W / H, distance=1.3).orbit(h, v, 0.0).matrices()
    want = tpu_gate(arrays, mj, params(cone, step))
    got, (feats, cone_feats, levels, sign) = port_gate(arrays, mj, params(cone, step))
    assert want.any(), "the gate never engages"
    parity.check_gate(want, got, f"view {jslab.dominant_axis(mj)} cone={cone} step {step}")
    # both conditions of the bit engage: without the opaque level the gate
    # sets more bits
    no_opaque = slab.lookahead_gate(feats, cone_feats, levels.clamp(max=1), sign, 8)
    assert int(no_opaque.sum()) > int(got.sum())


@pytest.mark.parametrize("step", STEPS)
@pytest.mark.parametrize("cone", [False, True], ids=["straight", "cone"])
@pytest.mark.parametrize("h,v", [(30.0, 20.0), (210.0, 20.0)])
def test_teapot_gate_matches_tpu_kernel(h, v, cone, step):
    arrays = teapot_scene()
    mj = vj.Camera(aspect=W / H, distance=1.3).orbit(h, v, 0.0).matrices()
    want = tpu_gate(arrays, mj, params(cone, step))
    got, _ = port_gate(arrays, mj, params(cone, step))
    assert want.any(), "the gate never engages"
    parity.check_gate(want, got, f"teapot view {jslab.dominant_axis(mj)} cone={cone} step {step}")


@pytest.mark.parametrize("planes", [16, 8, 32, 5])
def test_slab_resample_nearest_matches_jax(planes):
    grid = np.random.default_rng(3).uniform(0, 1, (16, 6, 7)).astype(np.float32)
    want = np.asarray(jslab.slab_resample_nearest(grid, planes))
    np.testing.assert_array_equal(want, slab.slab_resample_nearest(torch.from_numpy(grid), planes).numpy())


def test_importance_levels():
    imp = torch.tensor([0.0, 0.49, 0.5, 0.6, 0.99, 1.0], dtype=torch.float32).reshape(1, 2, 3)
    assert slab.importance_levels(imp).reshape(-1).tolist() == [0, 0, 1, 1, 1, 2]
    assert slab.importance_levels(imp).dtype == torch.uint8
    assert (slab.IMPORTANT_AHEAD_THRESHOLD, slab.IMPORTANCE_OPAQUE) == (
        lookahead_kernel.IMPORTANT_AHEAD_THRESHOLD, jslab.IMPORTANCE_OPAQUE
    )
    assert (golden.CONE_SAMPLES, golden.CONE_ANGLE) == (jgolden.CONE_SAMPLES, jgolden.CONE_ANGLE)


def test_nearest_tap_is_the_box_hat():
    """The nearest tap floor(c + 0.5), which the port and its kernels use,
    picks the TPU box hat's texel (c - i in [-0.5, 0.5)) at every snapped
    coordinate, the half-texel ones c = k + 0.5 included."""
    c = torch.arange(0, 15 * 256 + 1, dtype=torch.float32) / 256.0  # snapped (8 bits) in [0, 15]
    tap = torch.floor(c + 0.5)
    d = c[:, None] - torch.arange(16, dtype=torch.float32)[None, :]
    hat = ((d >= -0.5) & (d < 0.5)).float().argmax(1).float()
    assert torch.equal(tap, hat)
    assert float(torch.floor(torch.tensor(7.5) + 0.5)) == 8.0


def test_unpack_gate():
    bits = np.random.default_rng(4).random((70, 3, 5)) < 0.3
    words = np.zeros((3, 3, 5), np.uint32)
    for j in range(70):
        words[j // 32] |= bits[j].astype(np.uint32) << np.uint32(j % 32)
    got = lookahead.unpack_gate(torch.from_numpy(words.view(np.int32)), 70)
    assert got.dtype == torch.bool and tuple(got.shape) == (70, 3, 5)
    np.testing.assert_array_equal(got.numpy(), bits)
    assert lookahead.gate_words(64) == 2 and lookahead.gate_words(65) == 3


def test_gate_dispatches_cpu_tensors_to_plain_version():
    arrays = three_level_scene()
    mj = vj.Camera(aspect=W / H, distance=1.3).orbit(30.0, 20.0, 0.0).matrices()
    want, (feats, cone, levels, sign) = port_gate(arrays, mj, params(True, STEPS[0]))
    before = (lookahead.STRAIGHT_LAUNCHES, lookahead.CONE_LAUNCHES)
    assert torch.equal(lookahead.gate(feats, cone, levels, sign, 8), want)
    assert (lookahead.STRAIGHT_LAUNCHES, lookahead.CONE_LAUNCHES) == before
    with pytest.raises(ValueError, match="CUDA tensors"):
        lookahead.gate_cuda(feats, cone, levels, sign, 8)


def test_kernel_tables_match_python():
    """The CUDA kernels' row constants (csrc/slab_common.cuh) are the
    Python ones: one definition of each table's layout.  So are the march's
    tile, steps a batch and stage size (csrc/slab_march.cu), which
    ``slab_march.stage_plan`` transcribes."""
    src = (CSRC / "slab_common.cuh").read_text()
    consts = {k: int(v) for k, v in re.findall(r"\b([A-Z][A-Z0-9_]*) = (\d+)[,;]", src)}
    names = [n for n in dir(slab) if re.fullmatch(r"(F|CF)_[A-Z0-9]+|N_FEATURES|CF_STRIDE", n)]
    assert names and all(consts[n] == getattr(slab, n) for n in names), {n: (consts.get(n), getattr(slab, n)) for n in names}
    assert consts["CONE_SAMPLES"] == golden.CONE_SAMPLES
    assert consts["CF_STRIDE"] * consts["CONE_SAMPLES"] == slab.CONE_FEATURES
    names = ("MARCH_TILE_W", "MARCH_TILE_H", "MARCH_BATCH", "MARCH_BATCH_U8", "STAGE_BYTES")
    march = dict(re.findall(rf"constexpr int ({'|'.join(names)}) = (\d+);", (CSRC / "slab_march.cu").read_text()))
    layout = {n: getattr(slab_march, n) for n in names}
    assert {n: int(v) for n, v in march.items()} == layout
    plan = slab_march.stage_plan.__defaults__
    assert plan[-4:] == ((layout["MARCH_TILE_W"], layout["MARCH_TILE_H"]), None, layout["STAGE_BYTES"], True)
