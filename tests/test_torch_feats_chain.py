"""The plain rows' camera chain (B5) fused into the fold: the range proof
the CUDA kernel's ``CHAIN`` variant rests on, on the CPU.

The fused fold-and-scatter (``ops/csrc/voxel_grad.cu``) walks each ray's
plain rows ``[first - 3, last + 3]`` of the replay's step table (the
stencil's halo around the steps with a cotangent) and, at every nonzero
folded row, adds the row's coordinate chain to four register sums in row
order; it never makes the (N, H, W) tensor of folded rows that
``slab.feats_grad`` and the TPU's ``_run_feats_grad`` walk whole.  The card
is not here, so on a 16^3 volume at 32x32 rays (one 1024-ray TPU chunk),
smoothed trilinear sampling with camera gradients on its 16 native f32
planes, in every (major axis, sign) view, from a numpy seed:

- the plain folded rows (``slab.smooth_voxel_grad``) are exactly 0.0
  outside each ray's walk, and the walk leaves rows out;
- ``slab.feats_grad`` restricted to the walk, the nonzero rows in row
  order (a torch transcription of the kernel's sums), equals
  ``slab.feats_grad`` bit for bit; cut into chunks of 7 rows whose partial
  sums are added afterwards (the kernel's atomics with several chunks), it
  agrees by the repo's rule;
- ``slab.feats_grad`` agrees with the JAX package's ``_run_feats_grad``
  under the repo's emulator (``tests/pallas_emu.py``) with its full float32
  dots (``slab_kernel.EXACT_DOT = "x6"``), by the repo's rule, as
  ``tests/test_torch_camera_replay.py`` holds it.

And the dispatch: ``smooth_backward`` with its default functions on CPU
tensors is the plain composition and launches nothing; the CUDA entries
refuse tensors that are not on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.pallas_emu import emulate
from tests.test_torch_camera_replay import chunk, hold_rows
from volym_tpu.ops import slab_bwd_kernel, slab_kernel
from volym_tpu_torch import Camera, RenderParams, convert, parity
from volym_tpu_torch.ops import feats_grad, slab_march, voxel_grad
from volym_tpu_torch.render import slab
from volym_tpu_torch.render.slab import F_CB, F_CS, F_RB, F_RS, N_FEATURES, SMOOTH_HALO

SIDE, H, W = 16, 32, 32
#: one orbit for each (major axis, sign) view
VIEWS = [(30.0, 20.0), (210.0, 20.0), (120.0, 10.0), (300.0, -10.0), (20.0, 70.0), (20.0, -70.0)]


@pytest.fixture(scope="module")
def scene():
    """A ball of random density in an empty border, so that rays enter and
    leave the range of steps with a cotangent inside the sweep."""
    rng = np.random.default_rng(11)
    x = (np.arange(SIDE) + 0.5) / SIDE - 0.5
    ball = (x[:, None, None] ** 2 + x[None, :, None] ** 2 + x[None, None, :] ** 2) < 0.36**2
    vol = (rng.integers(0, 200, (SIDE,) * 3) * ball).astype(np.float32) / np.float32(255.0)
    lut = rng.uniform(0.0, 1.0, (256, 4)).astype(np.float32)
    lut[:, 3] *= 0.4
    return convert.scene(vol, np.zeros_like(vol), lut)


def _params():
    return RenderParams(use_gaussian_smoothing=True, interpolation="trilinear", use_shading=False,
                        density_threshold=0.15, raymarching_step_size=1.0 / SIDE, camera_grads=True)


def _replayed(scene, view):
    """The plain replay's cotangents and step table for one view -> (p, sign,
    feats, vol, dd, steps)."""
    p = _params()
    cam = Camera(aspect=W / H, distance=1.2).orbit(*view, 0.0).matrices()
    feats, vol, lut, sign, grad, u8 = slab_march.prepare(scene, cam, p, H, W)
    assert not u8 and vol.dtype == torch.float32 and vol.shape[0] == SIDE
    img = slab.march_slabs(feats, vol, lut, sign, p, grad)
    g = torch.from_numpy(np.random.default_rng(3).uniform(-1.0, 1.0, (H, W, 4)).astype(np.float32))
    dd, steps, _, _ = slab.replay_slabs(feats, vol, lut, sign, p, img, g, grad)
    return p, sign, feats, vol, dd, steps


def walk_bounds(steps, n):
    """Each ray's walk: plain rows ``[first - 3, last + 3]`` clamped to the
    sweep (``fold_scatter`` in csrc/voxel_grad.cu) -> (lo, hi), empty
    (lo > hi) where the ray has no cotangent."""
    first, last = steps.reshape(2, -1).long()
    live = first <= last
    lo = torch.where(live, torch.clamp(first - SMOOTH_HALO, min=0), n)
    hi = torch.where(live, torch.clamp(last + SMOOTH_HALO, max=n - 1), -1)
    return lo, hi


def kernel_chain(feats, vol, folded, steps, sign, params, rows_a_chunk=None):
    """The ``CHAIN`` sums of the fused kernel, transcribed over all rays at
    once: at each row of a ray's walk whose folded cotangent is nonzero,
    the row's coordinate chain (``slab._coord_chain``, as ``dsample`` and the
    masks) added to the four sums in row order.  With ``rows_a_chunk`` each
    chunk of rows sums on its own and the chunks' sums are added after, in
    chunk order (the kernel adds them by atomics in any order)."""
    n, nr, nc = vol.shape
    f = feats.reshape(N_FEATURES, -1)
    d = folded.reshape(n, -1)
    lo, hi = walk_bounds(steps, n)
    size = rows_a_chunk or n
    total = [torch.zeros_like(f[0]) for _ in range(4)]
    for start in range(0, n, size):
        sums = [torch.zeros_like(f[0]) for _ in range(4)]
        for k in range(start, min(start + size, n)):
            kk, _, rows_c, cols_c = slab._step_coords(f, k, n, nr, nc, sign, params.subtexel_bits)
            d_rows, d_cols = slab._coord_chain(vol[kk], rows_c, cols_c, slab._coord_masks(f, float(k), nr, nc), d[k])
            take = (k >= lo) & (k <= hi) & (d[k] != 0.0)
            terms = (d_rows * float(k), d_rows, d_cols * float(k), d_cols)
            sums = [torch.where(take, a + t, a) for a, t in zip(sums, terms)]
        total = sums if rows_a_chunk is None else [a + b for a, b in zip(total, sums)]
    out = torch.zeros_like(f)
    out[F_RS], out[F_RB], out[F_CS], out[F_CB] = total
    return out.reshape(feats.shape)


@pytest.mark.parametrize("view", VIEWS)
def test_fused_chain_range_proof(scene, monkeypatch, view):
    p, sign, feats, vol, dd, steps = _replayed(scene, view)
    n = vol.shape[0]
    folded = slab.smooth_voxel_grad(feats, dd, steps, vol.shape, sign, p, want_folded=True)[2]
    lo, hi = walk_bounds(steps, n)
    k = torch.arange(n)[:, None]
    outside = (k < lo) | (k > hi)
    d = folded.reshape(n, -1)
    # the walk leaves rows out, and every row it leaves out is 0.0
    assert int(outside.sum()) > 0 and int((~outside).sum()) > 0
    assert bool((d[outside] == 0.0).all()), "a folded row outside its ray's walk"
    assert float(d.abs().max()) > 0

    want = slab.feats_grad(feats, vol, folded, sign, p)
    assert float(want.abs().max()) > 0
    assert torch.equal(kernel_chain(feats, vol, folded, steps, sign, p), want)
    parity.check_close(want, kernel_chain(feats, vol, folded, steps, sign, p, rows_a_chunk=7), "chunked sums")

    # the TPU's pass 2b, emulated, on the same table, volume and folded rows
    monkeypatch.setattr(slab_kernel, "EXACT_DOT", "x6")
    with emulate(slab_kernel, slab_bwd_kernel):
        tpu = slab_bwd_kernel._run_feats_grad(
            chunk(feats), jnp.asarray(vol.numpy()), chunk(folded)[:, :, None], bilinear=True, win_rows=0,
            sb=slab_kernel.SLAB_BATCH, sign=sign, subtexel=p.subtexel_bits,
        )
    tpu = np.asarray(tpu)[0, :N_FEATURES].reshape(N_FEATURES, H, W)
    assert np.abs(tpu[: F_CB + 1]).max() > 0
    hold_rows(tpu, want, f"view {view} feats_grad vs _run_feats_grad")


def test_chain_dispatch_on_the_cpu(scene):
    p, sign, feats, vol, dd, steps = _replayed(scene, VIEWS[0])
    counts = (voxel_grad.FOLD_LAUNCHES, voxel_grad.FOLD_SHADED_LAUNCHES, feats_grad.LAUNCHES)
    d_vol, d_grad, d_feats = slab_march.smooth_backward(feats, dd, steps, vol, sign, p)
    want_vol, _, folded = slab.smooth_voxel_grad(feats, dd, steps, vol.shape, sign, p, want_folded=True)
    assert torch.equal(d_vol, want_vol) and d_grad is None
    assert torch.equal(d_feats, slab.feats_grad(feats, vol, folded, sign, p))
    assert (voxel_grad.FOLD_LAUNCHES, voxel_grad.FOLD_SHADED_LAUNCHES, feats_grad.LAUNCHES) == counts
    with pytest.raises(ValueError, match="CUDA tensors"):
        voxel_grad.fold_scatter_cuda(feats, dd, steps, vol.shape, sign, p, vol=vol)
    meta = [t.to("meta") for t in (feats, vol, folded)]
    with pytest.raises(ValueError, match="fused into the fold"):
        feats_grad.feats_grad(meta[0], meta[1], meta[2], sign, p)
