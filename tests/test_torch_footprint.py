"""The CUDA march's stage windows (B1, ``slab_march_kernel`` in
``volym_tpu_torch/ops/csrc/slab_march.cu``) cover every texel its samples
read, on the CPU.

The kernel marches a tile of rays a block in batches of K steps.  Before a
batch it stages, for each of its K slices, a window of texels in shared
memory, computed from the first and the last step of each ray's t-window
in the batch (the coordinates are monotone in the step) and reduced over
the tile; a sample then reads its texels from the window.  A texel outside
the window would be another texel, silently.  ``slab_march.stage_plan``
transcribes that computation in torch.  Here, with ``hypothesis`` drawing
cameras, tiles, K, sampling, smoothing, shading, importance coloring and
where each ray's alpha ends its march, every texel index that the plain
version's taps (``slab._bilinear_taps`` / ``slab._nearest_tap`` at
``slab._step_coords``) give for every sample a live ray takes lies inside
the window of its step: the density sample (under smoothing the plain row
j + 3 that the sliding window takes at step j), and, in the aux window, the
gradient field's at the step's own coordinates and coloring's importance
box tap there.  The transcription's split of (block, batch) pairs into
staged and direct is also held to a count made by hand, one ray and one
step at a time in float32 scalars, on two fixed views.
"""

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from volym_tpu_torch import Camera, RenderParams, Scene
from volym_tpu_torch.ops import slab_march
from volym_tpu_torch.render import slab
from volym_tpu_torch.render.slab import F_CB, F_CS, F_ENTRY, F_EXIT, F_RB, F_RS, F_SIGNOK, F_TB, F_TS, SMOOTH_HALO

SIDE, H, W = 16, 24, 40
TILES = [(16, 16), (8, 8), (16, 8)]
#: native (16 planes), resampled (8) and refined (32) march planes
STEPS = [1.0 / SIDE, 2.0 / SIDE, 0.5 / SIDE]


def _scene():
    return Scene.synthetic("bonsai", side=SIDE, seed=0)


def _inputs(scene, h, v, dist, interp, step, smooth, shading, coloring=False):
    p = RenderParams(use_gaussian_smoothing=smooth, interpolation=interp, raymarching_step_size=step,
                     use_shading=shading, u8_volume=True, density_threshold=0.12, camera_grads=False,
                     use_importance_coloring=coloring)
    cam = Camera(aspect=W / H, distance=dist).orbit(h, v, 0.0).matrices()
    feats, vol, _, _, _, u8 = slab_march.prepare(scene, cam, p, H, W)
    return p, feats, vol.shape, u8


def _taps(f, s, shape, bits, bilinear):
    """The rows and columns the plain sample at march step ``s`` (per ray)
    reads: (r0, r1, c0, c1), each (R,)."""
    n, nr, nc = shape
    rows = slab.snap(torch.clamp(f[F_RS] * s.float() + f[F_RB], 0.0, nr - 1.0), bits)
    cols = slab.snap(torch.clamp(f[F_CS] * s.float() + f[F_CB], 0.0, nc - 1.0), bits)
    if bilinear:
        r0, r1, c0, c1, _, _ = slab._bilinear_taps(rows, cols, nr, nc)
        return r0, r1, c0, c1
    idx = slab._nearest_tap(rows, cols, nr, nc)
    return idx // nc, idx // nc, idx % nc, idx % nc


def _block_of(tile):
    """Each ray's block number (row-major over the tiles)."""
    tw, th = tile
    y, x = torch.meshgrid(torch.arange(H), torch.arange(W), indexing="ij")
    return ((y // th) * (-(-W // tw)) + x // tw).reshape(-1)


@settings(max_examples=30, deadline=None, derandomize=True, database=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(
    h=st.floats(0.0, 360.0), v=st.floats(-80.0, 80.0), dist=st.floats(0.9, 3.0), tile=st.sampled_from(TILES),
    batch=st.sampled_from([4, 8, 16]), interp=st.sampled_from(["nearest", "trilinear"]),
    step=st.sampled_from(STEPS), smooth=st.booleans(), shading=st.booleans(), coloring=st.booleans(),
    stop_seed=st.integers(0, 3),
)
def test_windows_cover_every_sample(h, v, dist, tile, batch, interp, step, smooth, shading, coloring, stop_seed):
    p, feats, shape, u8 = _inputs(_scene(), h, v, dist, interp, step, smooth, shading, coloring)
    n = shape[0]
    f = feats.reshape(feats.shape[0], -1)
    # where each ray's alpha ends its march: never (seed 0) or a random step
    rng = np.random.default_rng(stop_seed)
    stop = torch.full((H * W,), n) if stop_seed == 0 else torch.from_numpy(rng.integers(0, n + 1, H * W))
    plan = slab_march.stage_plan(feats, shape, u8, p, stop=stop.reshape(H, W), tile=tile, batch=batch)
    bilinear = interp == "trilinear"
    halo = SMOOTH_HALO if smooth else 0
    block = _block_of(tile)
    live = (f[F_SIGNOK] > 0.5) & ~(f[F_EXIT] <= f[F_ENTRY])
    checked = 0
    for j in range(n):
        b = j // batch
        t = f[F_TS] * float(j) + f[F_TB]
        # alive at the start of batch b: not past its exit or its stop
        t_prev = f[F_TS] * float(b * batch - 1) + f[F_TB]
        alive = live & (stop >= b * batch) & ((b == 0) | (t_prev < f[F_EXIT]))
        reads = alive & (t >= f[F_ENTRY]) & (t < f[F_EXIT])
        if not bool(reads.any()):
            continue
        blk = block[reads]
        assert bool(plan.visited[b, blk].all()), f"step {j}: a sampling ray's block skips batch {b}"
        wanted = ([("density", plan.dens_box, j + halo, bilinear)]
                  + ([("gradient", plan.grad_box, j, bilinear)] if shading else [])
                  + ([("importance", plan.grad_box, j, False)] if coloring else []))  # its box tap
        for what, boxes, s, hats in wanted:
            if s > n - 1:
                continue
            box = boxes[b, blk]
            r0, r1, c0, c1 = _taps(f[:, reads], torch.full((int(reads.sum()),), s), shape, p.subtexel_bits, hats)
            inside = (box[:, 0] <= r0) & (r1 <= box[:, 1]) & (box[:, 2] <= c0) & (c1 <= box[:, 3])
            assert bool(inside.all()), f"step {j}: {int((~inside).sum())} {what} samples read outside the window"
            checked += int(reads.sum())
    assert checked or not bool(live.any())


def _hand_count(feats, shape, u8, p, tile, batch, cap):
    """(staged, direct) (block, batch) pairs, one ray and one step at a time
    in float32 scalars: the kernel's first batch, the rays its plan takes
    (alive at the start of the previous batch), the box of every tap their
    samples can read (the steps of their t-window bounds), and whether K
    slices of it, rows in 16-byte chunks, fit."""
    n, nr, nc = shape
    f = feats.reshape(feats.shape[0], -1).numpy()
    tw, th = tile
    halo = SMOOTH_HALO if p.use_gaussian_smoothing else 0
    bilinear = p.interpolation.value == "trilinear"
    elem = 1 if u8 else 4
    f32 = np.float32

    def coord(s, b, j, hi):
        c = min(max(f32(f32(s * f32(j)) + b), f32(0.0)), f32(hi))
        if p.subtexel_bits:
            sc = f32(1 << p.subtexel_bits)
            c = f32(np.floor(f32(c * sc) + f32(0.5)) * f32(f32(1.0) / sc))
        return c

    def span(c, n_tex):
        if bilinear:
            lo = int(np.floor(c))
            return min(max(lo, 0), n_tex - 1), min(max(lo + 1, 0), n_tex - 1)
        r = min(max(int(np.floor(c + f32(0.5))), 0), n_tex - 1)
        return r, r

    staged = direct = 0
    for by in range(-(-H // th)):
        for bx in range(-(-W // tw)):
            rays = [y * W + x for y in range(by * th, min(H, by * th + th)) for x in range(bx * tw, min(W, bx * tw + tw))]
            live = {r for r in rays if not f[F_EXIT, r] <= f[F_ENTRY, r] and f[F_SIGNOK, r] > 0.5}
            if not live:
                continue
            first, last = {}, {}  # the t-window's bounds in steps
            for r in live:
                e = f32(np.floor(f32(f32(f[F_ENTRY, r] - f[F_TB, r]) / f[F_TS, r]))) - f32(1.0)
                first[r] = 0 if not e > 0 else (int(e) if e < n else n)
                e = f32(np.floor(f32(f32(f[F_EXIT, r] - f[F_TB, r]) / f[F_TS, r]))) + f32(1.0)
                last[r] = n - 1 if not e < n - 1 else (int(e) if e > -1 else -1)
            b_first = min(first.values()) // batch
            alive, plan_rays = set(live), set(live)
            for b in range(b_first, -(-n // batch)):
                if not alive:
                    break
                box = [nr, -1, nc, -1]
                for r in plan_rays:
                    for j in range(max(b * batch, first[r]), min(n, b * batch + batch, last[r] + 1)):
                        if j + halo > n - 1:
                            continue
                        rr = span(coord(f[F_RS, r], f[F_RB, r], j + halo, nr - 1), nr)
                        cc = span(coord(f[F_CS, r], f[F_CB, r], j + halo, nc - 1), nc)
                        box = [min(box[0], rr[0]), max(box[1], rr[1]), min(box[2], cc[0]), max(box[3], cc[1])]
                if box[0] <= box[1]:
                    b0, b1 = (box[2] * elem) // 16 * 16, -(-((box[3] + 1) * elem) // 16) * 16
                    if batch * (box[1] - box[0] + 1) * (b1 - b0) <= cap:
                        staged += 1
                    else:
                        direct += 1
                # composite batch b: a ray ends at its first step past its exit
                plan_rays = set(alive)
                for r in list(alive):
                    end = min(n, b * batch + batch) - 1
                    if f32(f32(f[F_TS, r] * f32(end)) + f[F_TB, r]) >= f[F_EXIT, r]:
                        alive.discard(r)
    return staged, direct


@pytest.mark.parametrize("interp,u8_step,smooth", [("trilinear", True, False), ("nearest", False, True)])
@pytest.mark.parametrize("h,v", [(30.0, 20.0), (210.0, 20.0)])
def test_staged_split_matches_hand_count(h, v, interp, u8_step, smooth):
    """On two views (each march sign), with a stage of 512 bytes a buffer,
    so that both routes occur."""
    p, feats, shape, u8 = _inputs(_scene(), h, v, 1.3, interp, 1.0 / SIDE if u8_step else 2.0 / SIDE, smooth, False)
    assert u8 == u8_step
    for tile, batch in ((TILES[0], 8), (TILES[1], 4)):
        want = _hand_count(feats, shape, u8, p, tile, batch, 512)
        got = slab_march.stage_plan(feats, shape, u8, p, tile=tile, batch=batch, stage_bytes=512).counts()
        assert got == want
        assert want[0] and want[1], f"both routes should occur: {want}"


def test_unaligned_rows_read_global_memory():
    """A volume whose rows do not start on 16 bytes is never staged."""
    p, feats, shape, u8 = _inputs(_scene(), 30.0, 20.0, 1.3, "nearest", 1.0 / SIDE, False, True)
    staged, direct = slab_march.stage_plan(feats, shape, u8, p, can_stage=False).counts()
    assert staged == 0 and direct > 0
    plan = slab_march.stage_plan(feats, shape, u8, p)
    assert plan.counts()[0] > 0 and not bool((plan.grad_staged & ~plan.dens_staged).any())


def test_unaligned_rows_read_global_memory_coloring():
    """Under coloring too (shaded: the aux window holds the gradient field
    and the importance), and the aux window is staged only beside a staged
    density window."""
    p, feats, shape, u8 = _inputs(_scene(), 30.0, 20.0, 1.3, "nearest", 1.0 / SIDE, False, True, True)
    staged, direct = slab_march.stage_plan(feats, shape, u8, p, can_stage=False).counts()
    assert staged == 0 and direct > 0
    plan = slab_march.stage_plan(feats, shape, u8, p)
    assert bool(plan.grad_staged.any()) and not bool((plan.grad_staged & ~plan.dens_staged).any())


def test_importance_shares_the_aux_stage():
    """Coloring's importance adds K slices to the aux window: the window
    stays the same, and a pair whose gradient field fits with its
    importance fits without it."""
    base = _inputs(_scene(), 30.0, 20.0, 1.3, "trilinear", 1.0 / SIDE, False, True)
    colored = _inputs(_scene(), 30.0, 20.0, 1.3, "trilinear", 1.0 / SIDE, False, True, True)
    a = slab_march.stage_plan(base[1], base[2], base[3], base[0], stage_bytes=4096)
    b = slab_march.stage_plan(colored[1], colored[2], colored[3], colored[0], stage_bytes=4096)
    assert torch.equal(a.grad_box, b.grad_box) and torch.equal(a.dens_staged, b.dens_staged)
    assert not bool((b.grad_staged & ~a.grad_staged).any()) and bool((a.grad_staged & ~b.grad_staged).any())
