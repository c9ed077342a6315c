#!/usr/bin/env python3
"""Drive volym_tpu_torch once on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--parent DIR ...]

``--parent DIR``: DIR is a checkout of another commit; its march (B1),
replay (B2), gate (B6, B7) and fold-and-scatter (B3, B4) kernels are built
from its sources and timed beside this checkout's on the same inputs in
every cell and route where they run (before / after, one process, one
card); where it has its own B5 (``csrc/feats_grad.cu``), the route of its
plain rows' camera chain (the (N, H, W) folded rows zero-filled, its fold
writing them, its B5 walking them) is timed part by part beside the fused
chain, and its camera step's peak memory beside this one's.  B2 is timed with the
allocations that checkout's wrapper made (a zero-filled ``dd`` before the
replay wrote only each ray's step range, see ``Before``).  Given more than
once, every checkout is timed, and the B2 line gives the share of the
first one's time that each later one (say, a copy of it with one part of
its kernel taken out) and the first one's zero-fill of ``dd`` save.

Phases, in order; any failure ends the run with a nonzero exit:

1. require CUDA and print the card's name and power limit;
2. build the CUDA kernels from ``volym_tpu_torch/ops/csrc`` (one nvcc per
   source, all started together): the march (B1), the replay (B2), the
   voxel-gradient scatters (B3 and B4, one source, fused with the smoothing
   stencil's transpose and without it, and the fused fold with the plain
   rows' camera chain, B5), the look-ahead gate (B6 straight and B7
   cone, one source) and the per-ray and cone tables (one source); print ptxas's registers and spills of every march,
   replay, gate and scatter kernel (the fold with the chain beside it
   without), and B7's occupancy
   (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``);
3. hold the kernels to their plain PyTorch versions on the card: 64^3
   synthetic bonsai, 96x64 rays, every (major axis, sign) view x {nearest,
   trilinear} x {u8 native planes, f32 resampled planes} x {shaded,
   unshaded}: the march (48 cases), the march with its stored-density
   residual, bit for bit (48), and the replay from the residual and
   re-sampled (96), whose two routes must also agree; then on a 64^3 scene
   with importance at three levels (:func:`three_level_scene`), every view
   x {u8 native, f32 resampled} x {straight, cone}: the gate kernels, bit
   for bit (24), and the march with the gate, bit for bit (24), and again
   with Gaussian smoothing (24); then Gaussian smoothing on the 256^3
   synthetic bonsai (every row of the stencil carries weight at 256
   planes), 96x64 rays, every view x {nearest, trilinear} x {u8 native 256
   planes, f32 resampled 128 planes} x {shaded, unshaded}: the march with
   its residual, bit for bit (48), the unfused replay from the residual and
   re-sampled (96), whose cotangents ``dd`` are held on each ray's step
   range (``slab.dense_dd``: the kernel writes nothing outside it), whose
   two routes must give the same cotangents bit for bit and whose step
   range must equal the plain one bit for bit (the plain ``dd`` must be 0.0
   outside it; the cases with ``dd`` bit-equal to the plain one are
   counted), the
   scatters B3 (unshaded) and B4 (shaded) without the fold on the folded
   cotangents (48), and the fused fold-and-scatter on the replay's
   cotangents and step range (48: every view x {nearest, trilinear} x
   {shaded, unshaded} x {folded rows asked for on 256 planes, not on 128}),
   with the count of folded rows bit-equal to the plain transpose's printed;
   then camera gradients (``camera_grads=True``, so f32)
   on the 64^3 bonsai, and on the 256^3 one under smoothing, at 96x64
   rays, every view x {nearest, trilinear} x {shaded, unshaded} x
   {smoothing off, on}: B2's camera mode against the plain replay (48,
   d_feats among its outputs, the step range bit for bit) and, under
   trilinear smoothing, the fold with B5 fused in (12) on the plain
   replay's cotangents: with one chunk of rows its d_feats bit for bit with
   the plain chain (``slab.feats_grad``) on the fold's own folded rows, with
   one chunk and with the default chunks by the repo's rule against the
   plain chain on the plain transpose's rows, with the counts of bit-equal
   d_feats printed; then the last modes of B1 and B2 on the 64^3
   three-level scene's volume with uniform importance, every view x {u8
   trilinear native, f32 nearest resampled} x {shaded, unshaded} x
   {smoothing off, on}: B1's importance coloring (48) and first-hit (48,
   half of them gated, straight or cone by view), bit for bit, B2's
   coloring mode (48; with its camera chain on the f32 cases, 24), B1's
   residual under the gate, bit for bit (48), and B2 gated from the
   residual and re-sampled (96; with its camera chain on the f32 cases,
   24), within the repo's rule;
4. serving: render the 256^3 synthetic bonsai at 1024x768 through
   ``make_renderer(..., backend="slab_cuda")``, 10 orbit frames 2 degrees
   apart in each of four configurations: the bench forward (trilinear, u8,
   threshold .15, step .005 -> 256 planes, unshaded) and the CLI default
   (nearest, threshold .12, step .01 -> 128 resampled f32 planes, shaded),
   each without and with Gaussian smoothing (``bench_gaussian``, and
   ``cli_default_gaussian``, the flags of ``screenshot`` with no options).
   The march's launch count shows the frames went through it; frame 0 is
   checked against the plain version (bit for bit under smoothing); the
   kernel and the plain version are timed with CUDA events.  Then the
   per-ray and cone tables' kernels at 1024x768 against the chain of
   PyTorch ops they replace (``slab_march.table_chain``), every view x
   {128, 48 rows} x {per-ray, cone}, bit for bit with NaN in the same
   places (24), each timed beside the chain.  On this and every later main
   path the tables' launch counts start at 0 and must read one per-ray
   table a march and one cone table a cone gate (:func:`read_tables`);
5. serving with importance look-ahead: the 256^3 teapot stand-in (its
   lobster is important) at 1024x768 through ``make_renderer(...,
   backend="slab_cuda")``, the reference sweep's preset ``BENCHMARK_PARAMS``
   (threshold .15, shaded, nearest, no smoothing) at step .005 (256 native
   planes, u8) as Base, Importance and ImportanceCone, and ImportanceCone
   at step .01 (128 resampled f32 planes), 10 orbit frames each.  The
   launch counts of B1, B6 and B7 show the frames went through them; frame
   0 is checked against the plain path (the image by the repo rule, the
   gate bit for bit); the gate kernel, the march with the gate and the
   frame are timed with CUDA events; the shares of set gate bits and of
   pixels that differ from Base (above 0: the gate engaged) are printed,
   and for B6 the shares of valid steps whose range test ran and whose
   tap was taken (:func:`straight_gate`), with its bound on that count
   beside the bound of the count before its skips; one ImportanceCone
   frame is profiled.  Then the gate kernels alone, each bit for bit with
   the plain gate and timed beside each ``--parent``'s: B6 at step .01
   (128 resampled planes), and B6 and B7 on dense importance (the teapot
   with importance ``0.5 + 0.5 * volume``: every texel important, opaque
   where the volume is 1, so that no tap is skipped and every ray passes
   an important texel);
5b. importance coloring and first-hit at full size on the teapot: the
   frames of ``RenderParams()`` with ``use_importance_coloring`` and with
   ``use_opacity`` off (shaded, smoothed, 128 f32 planes), 10 orbit frames
   each through ``make_renderer``; the launch counts, frame 0 bit for bit
   with the plain path, the share of pixels that differ from the
   TF-composited frame, B1 and the frame timed with CUDA events beside the
   plain versions, B1's bound, and the device busy and idle shares of a
   frame (``torch.profiler``);
6. training: the ``bench.py`` step, ``sum(render_diff)`` with gradients for
   the volume and the LUT (trilinear, u8, threshold .15, 256 planes,
   unshaded, no camera gradients), through ``make_renderer(...,
   differentiable=True)`` at 256x256 and at 1024x768, a few steps each.
   The launch counts of the march and the replay equal the steps; step 0's
   image and gradients are checked against the plain version (the LUT
   gradient in two groups, ``parity.check_lut_grad``); the forward
   with the residual, the residual's zero-fill, the replay and the whole
   step are timed with CUDA events beside the plain step, and the step is
   profiled (device busy time, idle share, kernels by device time); then
   the march and the replay with the residual and without it are timed
   in both serving configurations; then the training step under Gaussian
   smoothing in ``bench_gaussian`` and ``cli_default_gaussian`` at 256x256
   and 1024x768, a few steps each, with the plain transpose made to raise
   on CUDA tensors: the launch counts of the march, the replay and the
   fused fold-and-scatter (B3 unshaded, B4 shaded) equal the steps and the
   scatter without the fold is not launched; the replay route each takes is
   printed; step 0 is checked against the plain step, the fused kernel
   (with its default chunk of rows a thread and with chunks of 16), the
   scatter without the fold and B2's cotangents and step range on both
   routes against their plain versions; the step ranges' statistics (the
   rows walked, the dd entries in range, the nonzero entries, N x R) are
   printed (on ``slab.dense_dd`` of B2's cotangents, as the plain transpose,
   the plain fold and the scatter without the fold read them); B1 with
   smoothing and its residual, B2 unfused on each route (with its bound on
   each route, and the bound with all of ``dd`` written), the
   fused kernel with 5 chunk sizes (beside ``index_add_`` of the nonzero
   folded entries' precomputed corner indices and weights, and its bound), the
   scatter without the fold and the whole step are timed with CUDA events,
   the plain transpose and the plain fold-and-scatter once, and a step is
   profiled and must launch fewer device kernels than the plain transpose
   alone; at 1024x768 the re-sampled route is also
   forced (a zero residual budget) and its step checked and timed; then the
   smoothed training step with camera gradients (the default
   ``camera_grads=True``; f32 planes, re-sampled replay) in both smoothed
   configurations at 1024x768, a few steps each, with ``inverse_view_proj``
   and ``position`` as leaves, the plain transpose and the plain rows'
   plain chain made to raise on CUDA tensors: the launch counts of B1, B2,
   the fused B3 or B4, and B5 fused into it (trilinear only: one launch of
   the fold with the chain) equal the steps; step 0's image, d_volume,
   d_lut and camera gradient are checked against the plain step; the
   fused chain's d_feats against the plain chain (bit for bit with one
   chunk of rows, the default at this size), the folded rows of the fold
   (asked for in this check only) against the plain transpose's, and the
   chain on a ``dd`` NaN-filled outside each step range (finite, as on the
   replay's own ``dd``); B2 with and without its camera chain (with their
   bounds), the fold without the chain (beside each ``--parent``'s), the
   fold with the chain (with its bound, and B5's own bound recounted on
   this run's data: the nonzero folded entries, 4 table rows in and out,
   the distinct texels its taps touch), each ``--parent``'s route of B5
   part by part, and the whole step are timed with CUDA events beside the
   step without camera gradients, the plain transpose and the plain fold
   and chain once, and a step is profiled; the step's peak memory must lie
   at least the (N, H, W) folded rows (less 64 MB) below the step whose
   fold writes them for a B5 that walks them;
6d. the new modes' training steps at 1024x768 on the teapot through
   ``make_renderer(..., differentiable=True)``: Importance and
   ImportanceCone (the sweep preset) without and with camera gradients, and
   importance coloring (``RenderParams()``'s defaults) with d_importance, a
   few steps each; the launch counts of B1, B2, B6 and B7 (and none of
   B3-B5: coloring folds nothing), step 0's image bit for bit and its
   volume, LUT, importance and camera gradients against the plain step,
   the gate, B1 and B2 (with their bounds) and the step timed with CUDA
   events, and the step's device busy and idle shares;
7. descent: 20 Adam steps (lr 1e-2, clamped to [0, 1]) on the volume and
   the LUT from a flat volume towards an image of the bonsai, on the f32
   stream (u8_volume=False, as fitting requires); the loss must fall;
8. write four screenshots through the CLI with its default flags
   (Gaussian smoothing on), the others with ``--importance --cone --scene
   teapot``, ``--coloring --scene teapot`` and ``--first-hit``;
9. the t-step renderers (``make_renderer(..., backend="ray")``: ``fast``
   to serve, ``diff`` to train; PyTorch ops, which must launch none of the
   kernels above), :func:`tstep_path`: (a) the 256^3 bonsai at 1024x768
   with ``RenderParams()`` (what ``python -m volym_tpu screenshot``
   renders), 3 orbit frames timed by CUDA events with their peak memory,
   frame 0 bit for bit with ``golden.render``, the steps ``fast`` ran
   against its bound and ``resolved_max_steps()``, one frame profiled
   (device busy and idle shares, kernel launches); the 256^3 teapot at
   1024x768 with ``BENCHMARK_PARAMS`` as Base, Importance and
   ImportanceCone, one frame each, bit for bit with the golden, with the
   share of pixels that differ from Base; (b) the same scenes and params
   at 96x64 on the card and on the CPU, held by ``parity.check_close``;
   (c) 3 training steps of ``sum(render)`` in ``bench.py``'s config on the
   f32 volume at 256x256, gradients for the volume, the LUT and the camera
   matrices, step 0's held to autograd through ``golden.render`` (adaptive
   off) at 96x64 by ``tests/test_diff.py``'s rule, the step and autograd
   through the golden at 256x256 timed with their peak memory, and one
   coloring step (d_importance) on the teapot; (d) the march-length
   histogram (``debug_vis.step_count_histogram``) of the (a) frame; and
   ``screenshot --renderer ray``.  One JSON line, ``{"tstep": ...}``,
   with the phase's wall time;
10. the CLI's other subcommands and the harness, :func:`cli_path`: (a)
   ``benchmark`` with its defaults (the 256^3 bonsai at 1024x768,
   ``slab_cuda``) at step .005, 1 trial of 0.25 s a row: 7 rows (Base,
   Importance and ImportanceCone at 3 look-aheads) in the JAX package's CSV
   schema, rays/s above 0, B1 launched at least once a counted frame in
   every row, B6 only in the Importance rows and B7 only in the
   ImportanceCone rows (the launch counts start at 0 before the sweep, a
   main path, and are read after it), each row's frame ms and rays/s
   printed; (b) ``benchmark --profile DIR`` at step .02, whose
   ``torch.profiler`` trace must name ``slab_march_kernel``; (c) the
   harness's host clock on ``bench.py``'s forward frame at 1024x768:
   ``marginal_time``, above 0; (d) ``fit_scene`` on the
   256^3 bonsai at 256x256 rays with the CLI ``fit``'s parameters, 3 steps
   timed by CUDA events, its peak memory over what was allocated before,
   the loss finite and falling; (e) the CLI ``fit`` on the 32^3 sphere at
   64x64, 10 steps at threshold .05: the loss falls and its ``.npz`` reads
   back with a (32, 32, 32) volume and the LUT's shape; (f) ``run
   --renderer ray --live-sweep``, 3 frames at 96x64, writes a PNG.  One JSON
   line, ``{"cli": ...}``, with the phase's wall time;
11. distribution and the viewer, :func:`distributed_path`, every launch
   count at 0 before it and read after it (a main path): (a) a one-rank
   NCCL group through ``launch.maybe_initialize``; (b) ``render_sharded``
   (``slab_cuda``) at 1024x768 of the 256^3 bonsai in
   ``cli_default_gaussian`` and of the teapot in ImportanceCone (the sweep
   preset at step .005) on meshes of 1 and of 4 virtual shards on the
   card: each frame bit for bit with ``make_renderer``'s, B1 (and B7)
   launched once a shard, the sharded and the single-device frames timed by
   CUDA events; (c) ``make_train_step(backend="slab_cuda")`` at 256x256 in
   ``bench.py``'s config and smoothed with camera gradients (B3 with B5
   fused in launched once a shard), on 1 and 4 shards, held to autograd
   through the single-device ``render_diff`` by the repo's rule, both
   steps timed; (d) the NCCL ``all_reduce`` of a 67
   MB d_volume timed; (e) ``fit_distributed``, 5 steps: the loss falls;
   (f) the CLI ``fit --distributed`` (the 32^3 sphere at 64x64, the loss
   falls) and ``benchmark --scaling`` (one row); (g) the viewer on
   127.0.0.1:0 in a thread: ``/frame`` at 1024x768 is the renderer's frame
   (its PNG bytes), its render ms from ``X-Render-Ms``, and one
   ``/screenshot``; the group is destroyed at the end.  One JSON line,
   ``{"distributed": ...}``, with the phase's wall time.

In phases 3-6 each case and cell where B1 runs also prints how its
(block, batch) pairs split between the staged route and the direct one,
from the transcription of the kernel's plan (``slab_march.stage_plan``) on
the case's own inputs; the small cases must take both routes.

The routes of the new modes run only in this checkout's kernels: a
``--parent`` checkout's entry ignores the gate, the importance and the
colour mode, so its times are given for the routes it has.

The fourth-to-last line gives B2's ms in every route and cell (fused,
stored and re-sampled, at 256x256 and 1024x768; unfused, stored and
re-sampled, in both smoothed cells at both sizes; with and without the
camera chain in both) beside each ``--parent`` checkout's and its bound;
the third-to-last line gives, for every cell, B1's, B6's and B7's ms
(and each ``--parent`` checkout's, or null) and B1's staged share, with
B7's occupancy; the second-to-last line is a JSON summary of the kernels
(B1's and B2's rows with the new modes' times and bounds under
``modes``; the tables' rows with their launches on the main paths); the
last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

SMALL_SIDE, SMALL_H, SMALL_W = 64, 64, 96
FULL_SIDE, FULL_H, FULL_W = 256, 768, 1024
FRAMES = 10
TRAIN_SIZES = ((256, 256), (FULL_H, FULL_W))
TRAIN_STEPS = 4
GAUSS_TRAIN_STEPS = 3
CAM_STEPS = 3
MODE_STEPS = 3
DESCENT_STEPS = 20
#: fit_scene's steps in the CLI phase
FIT_STEPS = 3
#: the t-step phase's orbit frames and training steps
TSTEP_FRAMES = 3
TSTEP_TRAIN_STEPS = 3
#: the share of gradient entries that may take the other side of a
#: knife-edge mask between the t-step replay and autograd through the golden
#: (three times the 14 of 16.8M d_volume entries seen on an H100 80GB HBM3),
#: and how far off such an entry may be, in the scale (twice the 0.051 seen)
TSTEP_KNIFE_EDGE_SHARE = 2.5e-6
TSTEP_KNIFE_EDGE_ERR = 0.1
ORBITS = [(30.0, 20.0), (210.0, 20.0), (120.0, 10.0), (300.0, -10.0), (20.0, 70.0), (20.0, -70.0)]
KERNELS = {
    "slab_march": ("volym_tpu_torch/ops/csrc/slab_march.cu", "volym_tpu/ops/slab_kernel.py:91"),
    "slab_replay": ("volym_tpu_torch/ops/csrc/slab_replay.cu", "volym_tpu/ops/slab_bwd_kernel.py:169"),
    "lookahead_straight": ("volym_tpu_torch/ops/csrc/lookahead.cu", "volym_tpu/ops/lookahead_kernel.py:125"),
    "lookahead_cone": ("volym_tpu_torch/ops/csrc/lookahead.cu", "volym_tpu/ops/lookahead_kernel.py:262"),
    "voxel_grad": ("volym_tpu_torch/ops/csrc/voxel_grad.cu", "volym_tpu/ops/slab_bwd_kernel.py:1127"),
    "voxel_grad_shaded": ("volym_tpu_torch/ops/csrc/voxel_grad.cu", "volym_tpu/ops/slab_bwd_kernel.py:1198"),
    "feats_grad": ("volym_tpu_torch/ops/csrc/voxel_grad.cu", "volym_tpu/ops/slab_bwd_kernel.py:968"),
    # the JAX package builds these two tables with jnp ops, no kernel
    "ray_table": ("volym_tpu_torch/ops/csrc/ray_table.cu", "volym_tpu/ops/slab_kernel.py:1279"),
    "cone_table": ("volym_tpu_torch/ops/csrc/ray_table.cu", "volym_tpu/ops/slab_kernel.py:2257"),
}
#: the sources to build, one nvcc each: csrc/<name>.cu
SOURCES = sorted({Path(src).stem for src, _ in KERNELS.values()})
#: H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and f32 operations/s
#: outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
#: f32 operations of one composited step, counted from the kernel sources
#: (a transcendental counts as one): the unshaded march step, and the
#: unshaded replay step with its TF chain and 4-tap scatter
MARCH_OPS_PER_STEP = 70
REPLAY_OPS_PER_STEP = 150
#: f32 operations of the smoothing stencil a sampled step (smooth_density in
#: csrc/slab_common.cuh: 5 taps of ~57, the offset, the box test and 7 hats
#: with their products and sums) plus the window's one new plain sample
SMOOTH_OPS_PER_STEP = 300
#: f32 operations of the scatter (csrc/voxel_grad.cu) a nonzero channel:
#: the coordinates and the snap once, and the 4 weights and products
SCATTER_OPS_PER_ENTRY = 30
#: f32 operations of the fused fold (csrc/voxel_grad.cu, FOLD), counted
#: from the source: a ray's constants (5 taps: the offset, its two
#: products and 7 hats of 5 operations each), a nonzero source step's
#: in-box bits and wsum (the raw coordinates, 5 taps of 3 sums, 6 compares
#: and the weight's sum), and each offset's term of a nonzero source (5
#: selected sums, a division, a product and the row's sum); each nonzero
#: plain row or channel then scatters (SCATTER_OPS_PER_ENTRY)
FOLD_OPS_PER_RAY = 190
FOLD_OPS_PER_SOURCE = 55
FOLD_OPS_PER_TERM = 13
#: f32 operations of the plain rows' camera chain (csrc/voxel_grad.cu,
#: CHAIN) a nonzero folded row, beyond the fold's own: the raw coordinates
#: (4), dsample's fractions and its two contractions (20), the masks (4),
#: the two products and the four sums (8)
CHAIN_OPS_PER_ROW = 36
#: f32 operations of the gate kernels (csrc/lookahead.cu), counted from the
#: source: every swept step of a live ray (t and the window compares), a
#: valid step's range test (straight: norm_pos, the quotient, the compare
#: and the ray's own snapped sample; cone: norm_pos and 8 range compares),
#: a cone probe's coordinates and box test at every swept step, an in-box
#: probe's snapped sample, and the ray's own sample where a cone bit is set.
#: The straight step splits into its range test (norm_pos, the quotient and
#: the compare) and its tap (the clamped coordinates, the snap, the nearest
#: tap and the level's two compares), each counted where the kernel must
#: do it (:func:`straight_gate`); STRAIGHT_OPS_VALID, both at every valid
#: step, is the count before the kernel skipped them
GATE_OPS_SWEPT = 5
STRAIGHT_OPS_VALID = 35
STRAIGHT_OPS_RANGE = 12
STRAIGHT_OPS_TAP = 23
CONE_OPS_VALID = 40
CONE_OPS_PROBE = 11
CONE_OPS_INBOX = 16
CONE_OPS_MAIN = 20
#: the rows of the per-ray table the gate kernels read (csrc/lookahead.cu):
#: both read these and no others
GATE_FEATURE_ROWS = ("F_RS", "F_RB", "F_CS", "F_CB", "F_TS", "F_TB", "F_ENTRY", "F_EXIT", "F_SIGNOK", "F_CD", "F_C2")


def log(*args):
    print(*args, flush=True)


def three_level_scene(side: int, seed: int = 5):
    """(volume, importance, LUT) numpy arrays of a scene with importance
    at all three look-ahead levels: a low-density noise volume with four
    dense shells, each around an importance sphere of raw 153 (level 1:
    important ahead, not opaque) or 255 (level 2: opaque), the rest raw 0.
    The volume and the importance are u8-representable."""
    import numpy as np

    rng = np.random.default_rng(seed)
    z, y, x = np.meshgrid(*(np.arange(side) + 0.5,) * 3, indexing="ij")
    vol = rng.integers(0, 60, (side,) * 3)
    imp = np.zeros((side,) * 3, np.uint8)
    f = side / 16.0
    for (cz, cy, cx), rad, raw in [((5, 5, 5), 3.0, 153), ((10, 10, 9), 3.0, 255),
                                   ((5, 11, 10), 2.5, 153), ((11, 5, 6), 2.5, 255)]:
        r = np.sqrt((z - cz * f) ** 2 + (y - cy * f) ** 2 + (x - cx * f) ** 2)
        vol = np.where(r < (rad + 1.5) * f, np.maximum(vol, 140), vol)
        imp = np.where(r < rad * f, raw, imp)
    lut = rng.uniform(0.0, 1.0, (256, 4)).astype(np.float32)
    lut[:, 3] *= 0.3
    return vol.astype(np.float32) / np.float32(255.0), imp.astype(np.float32) / np.float32(255.0), lut


def cuda_ms(fn, reps):
    """Mean milliseconds per call over ``reps`` calls, by CUDA events, after
    one warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound(n_bytes: float, n_ops: float) -> tuple[float, str]:
    """The least time (ms) the card could take: the larger of the bytes over
    the memory rate and the operations over the f32 rate, and which."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S * 1e3, n_ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def peak_mb(fn) -> float:
    """The most memory (MB) ``fn`` holds on the card at once over what was
    allocated before it (``torch.cuda.max_memory_allocated``)."""
    import torch

    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - before) / 1e6


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def gate_bytes(feats, cone_feats, levels, words) -> int:
    """The bytes the gate kernels must move: the per-ray table's rows they
    read (``GATE_FEATURE_ROWS``), the cone table, the level grid (read by
    the bounds pass) and the packed words written."""
    return len(GATE_FEATURE_ROWS) * feats[0].numel() * feats.element_size() + nbytes(cone_feats, levels, words)


def gate_ops(feats, cone_feats, levels, gate, work=None) -> int:
    """The f32 operations the gate kernels do on these inputs (the
    ``*_OPS_*`` counts): a live ray (sign flag set, hitting the box) sweeps
    every step; its valid steps, a cone direction's in-box steps and the
    set bits are counted from the per-ray and cone tables.  With ``work``
    (:func:`straight_gate`'s counts, straight only), a step's sweep, its
    range test and its tap count only where the straight kernel must do
    them: the steps it visits, the range tests it runs and the taps within
    the span; without it, the sweep at every step of a live ray and both
    at every valid step."""
    import torch

    from volym_tpu_torch.render import slab

    if work is not None:
        return (GATE_OPS_SWEPT * work["visited"] + STRAIGHT_OPS_RANGE * work["range_tests"]
                + STRAIGHT_OPS_TAP * work["span_taps"])
    f = feats.reshape(feats.shape[0], -1)
    n, nr, nc = levels.shape
    live = (f[slab.F_SIGNOK] > 0.5) & (f[slab.F_EXIT] > f[slab.F_ENTRY])
    swept = int(live.sum()) * n
    valid = torch.zeros((), dtype=torch.int64, device=f.device)
    inbox = torch.zeros((), dtype=torch.int64, device=f.device)
    cf = None if cone_feats is None else cone_feats.reshape(-1, slab.CF_STRIDE, f.shape[1])
    for j in range(n):
        t = f[slab.F_TS] * float(j) + f[slab.F_TB]
        valid += (live & (t >= f[slab.F_ENTRY]) & (t < f[slab.F_EXIT])).sum()
        if cf is not None:
            rows = cf[:, slab.CF_RS] * float(j) + cf[:, slab.CF_RB]
            cols = cf[:, slab.CF_CS] * float(j) + cf[:, slab.CF_CB]
            t_c = cf[:, slab.CF_TS] * float(j) + cf[:, slab.CF_TB]
            box = (rows >= -0.5) & (rows <= nr - 0.5) & (cols >= -0.5) & (cols <= nc - 0.5) & (t_c > 0.0)
            inbox += (live & box).sum()
    if cf is None:
        return GATE_OPS_SWEPT * swept + STRAIGHT_OPS_VALID * int(valid)
    return (GATE_OPS_SWEPT * swept + CONE_OPS_VALID * int(valid) + CONE_OPS_PROBE * cf.shape[0] * swept
            + CONE_OPS_INBOX * int(inbox) + CONE_OPS_MAIN * int(gate.sum()))


def snapped_tap(c, bits):
    """The gate kernels' ``snapped_tap`` of a clamped coordinate: floor(c +
    0.5) for 0 bits, else (floor(c * 2^bits + 0.5) + 2^(bits-1)) >> bits."""
    import torch

    if bits == 0:
        return torch.floor(c + 0.5).long()
    i = torch.floor(c * float(1 << bits) + 0.5).long()
    return (i + (1 << (bits - 1))) >> bits


def straight_gate(feats, levels, sign, subtexel):
    """The straight gate kernel (B6, ``lookahead_kernel<false>``), one
    thread a ray over all rays at once -> (its gate (N, H, W) bool in march
    order, counts of what it does).

    A ray is in phase 1 while its ``ns`` is FAR and the per-ray proof that
    no such step sets its bit holds (``ts > 0`` and ``(n - 1) + max(exit,
    0) / ts < FAR``): it runs no range test, visits only the steps whose
    slice holds an important texel (:func:`important_bounds`) and taps
    only where the clamped coordinate lies within a texel of their rows
    and columns.  From the step below its first important tap (or from
    the top, where the proof fails) it is in phase 2: it visits every
    step, runs the range test at every valid one and taps wherever the
    slice holds an important texel.  Where ``t`` rounds monotone in j (0 <
    ts < inf, a finite tb) both phases visit the ray's valid steps alone.

    Counted: the steps visited, the valid steps, the range tests run, the
    taps taken, the taps within the span (those the kernel must take in
    either phase), the set bits and the bits set while ``ns`` was FAR.
    Raises where a skipped range test would have been true or a skipped
    tap would have read level >= 1."""
    import torch

    from volym_tpu_torch.render import slab
    from volym_tpu_torch.render.rays import sqrt_rn

    _, height, width = feats.shape
    f = feats.reshape(slab.N_FEATURES, -1)
    n, nr, nc = levels.shape
    lv = levels.reshape(n, -1)
    entry, exit_, ts, tb = f[slab.F_ENTRY], f[slab.F_EXIT], f[slab.F_TS], f[slab.F_TB]
    live = (f[slab.F_SIGNOK] > 0.5) & ~(exit_ <= entry)
    has, r0, r1, c0, c1 = important_bounds(levels)
    has = has.tolist()
    r_lo, r_hi, c_lo, c_hi = ((b.float() + off).tolist() for b, off in ((r0, -1.0), (r1, 1.0), (c0, -1.0), (c1, 1.0)))
    far_clean = (ts > 0.0) & (float(n - 1) + torch.fmax(exit_, torch.zeros_like(exit_)) / ts < slab.FAR)
    windowed = (ts > 0.0) & torch.isfinite(ts) & torch.isfinite(tb)
    ns = torch.full_like(ts, slab.FAR)
    gate = torch.zeros((n, f.shape[1]), dtype=torch.bool, device=f.device)
    counts = {key: torch.zeros((), dtype=torch.int64, device=f.device)
              for key in ("visited", "valid", "range_tests", "taps", "span_taps", "set_while_far")}
    for j in reversed(range(n)):
        jf = torch.tensor(float(j), dtype=torch.float32, device=f.device)
        k = j if sign > 0 else n - 1 - j
        t = ts * jf + tb
        valid = live & (t >= entry) & (t < exit_)
        phase1 = (ns == slab.FAR) & far_clean
        swept = live & (valid | ~windowed)
        visited = swept if has[k] else swept & ~phase1
        tested = valid & ~phase1
        m_end = jf + (exit_ - sqrt_rn(torch.clamp(f[slab.F_C2] + 2.0 * t * f[slab.F_CD] + t * t, min=0.0))) / ts
        ahead = valid & (ns <= m_end)
        if bool((ahead & ~tested).any()):
            raise AssertionError(f"straight gate, step {j}: a skipped range test would have been true")
        rows_c = torch.clamp(f[slab.F_RS] * jf + f[slab.F_RB], 0.0, nr - 1.0)
        cols_c = torch.clamp(f[slab.F_CS] * jf + f[slab.F_CB], 0.0, nc - 1.0)
        level = lv[k][snapped_tap(rows_c, subtexel) * nc + snapped_tap(cols_c, subtexel)]
        span = valid & has[k] & (rows_c >= r_lo[k]) & (rows_c <= r_hi[k]) & (cols_c >= c_lo[k]) & (cols_c <= c_hi[k])
        if bool((valid & ~span & (level >= 1)).any()):
            raise AssertionError(f"straight gate, step {j}: a skipped tap would have read an important texel")
        tap = span | (tested & has[k])
        bit = ahead & tested & ~(tap & (level >= 2))
        counts["set_while_far"] += (bit & (ns == slab.FAR)).sum()
        ns = torch.where(tap & (level >= 1), jf, ns)
        gate[j] = bit
        for key, mask in (("visited", visited), ("valid", valid), ("range_tests", tested), ("taps", tap),
                          ("span_taps", span)):
            counts[key] += mask.sum()
    counts = {key: int(v) for key, v in counts.items()}
    counts["set_bits"] = int(gate.sum())
    return gate.reshape(n, height, width), counts


def scatter_indices(feats, dd, vol_shape, sign, params):
    """What the scatter (B3, or B4 for a 4-channel ``dd``) adds, as one
    ``index_add_``: the flat indices of every nonzero per-step cotangent's
    bilinear corners (or box texel) in its grid, the grids stacked (d_vol,
    then the 3 d_grad channels), the weighted values, and the stacked size."""
    import torch

    from volym_tpu_torch.config import Interpolation
    from volym_tpu_torch.render import slab

    f = feats.reshape(slab.N_FEATURES, -1)
    n, nr, nc = vol_shape
    d = dd.reshape(n, dd.shape[1] if dd.dim() == 4 else 1, -1)
    bilinear = params.interpolation == Interpolation.TRILINEAR
    idx, vals = [], []
    for j in range(n):
        k, _, rows_c, cols_c = slab._step_coords(f, j, n, nr, nc, sign, params.subtexel_bits)
        for c in range(d.shape[1]):
            nz = torch.nonzero(d[j, c]).squeeze(1)
            if not nz.numel():
                continue
            v, base = d[j, c][nz], (c * n + k) * nr * nc
            if bilinear:
                r0, r1, c0, c1, tr, tc = slab._bilinear_taps(rows_c[nz], cols_c[nz], nr, nc)
                idx += [base + r0 * nc + c0, base + r0 * nc + c1, base + r1 * nc + c0, base + r1 * nc + c1]
                vals += [v * (1 - tr) * (1 - tc), v * (1 - tr) * tc, v * tr * (1 - tc), v * tr * tc]
            else:
                idx.append(base + slab._nearest_tap(rows_c[nz], cols_c[nz], nr, nc))
                vals.append(v)
    return torch.cat(idx), torch.cat(vals), d.shape[1] * n * nr * nc


def fold_inputs(feats, dd, steps):
    """What the fused fold-and-scatter reads on these inputs: the rows each
    ray walks (its step range and the stencil's halo, clamped to the sweep;
    their sum and the longest), the dd entries inside the ranges (every
    channel), the nonzero entries of dd, N x R, and the nonzero density
    (sources) and gradient-field (channels) entries that the operation
    count of :func:`fold_bound` reads."""
    import torch

    n, rays = dd.shape[0], feats.shape[1] * feats.shape[2]
    first, last = steps.reshape(2, -1).long()
    live = first <= last
    walks = (torch.clamp(last + 3, max=n - 1) - torch.clamp(first - 3, min=0) + 1)[live]
    walked = int(walks.sum())
    in_range = int((last - first + 1)[live].sum()) * (dd.shape[1] if dd.dim() == 4 else 1)
    d0 = dd[:, 0] if dd.dim() == 4 else dd
    sources = int((d0 != 0.0).sum())
    channels = int((dd[:, 1:] != 0.0).sum()) if dd.dim() == 4 else 0
    return dict(rays_with_range=int(live.sum()), walked_rows=walked,
                longest_walk=int(walks.max()) if walks.numel() else 0, in_range_entries=in_range,
                nonzero_entries=int((dd != 0.0).sum()), n_x_r=n * rays, sources=sources, channels=channels)


def fold_bound(feats, steps, folded_rows, out_tensors, stats, extra_bytes=0, extra_ops=0):
    """The fused kernel's bound: the in-range dd, the range table and 5 rows
    of the per-ray table read once, its outputs written once; the
    operations of :func:`fold_inputs` with ``folded_rows``, the nonzero
    plain rows it scatters; plus ``extra_bytes`` and ``extra_ops`` (the
    camera chain's)."""
    rays = feats.shape[1] * feats.shape[2]
    n_bytes = stats["in_range_entries"] * 4 + nbytes(steps) + 5 * rays * 4 + nbytes(*out_tensors) + extra_bytes
    ops = (stats["rays_with_range"] * FOLD_OPS_PER_RAY + stats["sources"] * (FOLD_OPS_PER_SOURCE + 7 * FOLD_OPS_PER_TERM)
           + (folded_rows + stats["channels"]) * SCATTER_OPS_PER_ENTRY + extra_ops)
    return bound(n_bytes, ops)


def chain_texels(feats, folded, vol_shape, sign, params) -> int:
    """The distinct texels of the f32 volume that the plain rows' camera
    chain reads: the 4 taps of ``dsample`` (texel nr and nc absent) at each
    nonzero folded row's snapped coordinates, in its plane."""
    import torch

    from volym_tpu_torch.render import slab

    f = feats.reshape(slab.N_FEATURES, -1)
    n, nr, nc = vol_shape
    d = folded.reshape(n, -1)
    touched = torch.zeros(n * nr * nc, dtype=torch.bool, device=folded.device)
    for j in range(n):
        nz = torch.nonzero(d[j]).squeeze(1)
        if not nz.numel():
            continue
        k, _, rows_c, cols_c = slab._step_coords(f[:, nz], j, n, nr, nc, sign, params.subtexel_bits)
        r0, c0 = torch.floor(rows_c).long(), torch.floor(cols_c).long()
        for dr in (0, 1):
            for dc in (0, 1):
                r, c = r0 + dr, c0 + dc
                inside = (r < nr) & (c < nc)
                touched[(k * nr + r[inside]) * nc + c[inside]] = True
    return int(touched.sum())


def replay_bounds(feats, vol, lut, grad, out, g, dens, dd, steps, stats, composited, stencils, d_feats_rows=0,
                  chain_ops=0):
    """B2's bound under smoothing on each route (only the re-sampled one
    without a residual ``dens``): the inputs once (the stored route reads
    the residual, its nonzero entries: a lower bound; the re-sampled one
    the volume and the gradient field), the in-range ``dd`` (every channel,
    ``stats`` of :func:`fold_inputs`), the range table, ``d_lut`` and
    ``d_feats_rows`` rows of ``d_feats`` written once; the operations of
    the composited steps (plus ``chain_ops``) and, re-sampled, of the
    ``stencils`` that run.  Beside each (``... whole dd``) the bound with
    all of ``dd`` written, as the replay wrote it before it wrote only the
    ranges."""
    rays = out.shape[0] * out.shape[1]
    common = nbytes(feats, lut, out, g, lut, steps) + d_feats_rows * rays * 4
    ops = composited * REPLAY_OPS_PER_STEP + chain_ops
    routes = {"re-sampled": (nbytes(vol, grad), ops + stencils * SMOOTH_OPS_PER_STEP)}
    if dens is not None:
        routes["stored"] = (int((dens != 0.0).sum()) * 4, ops)
    res = {}
    for route, (reads, n_ops) in routes.items():
        res[route] = bound(common + reads + stats["in_range_entries"] * 4, n_ops)
        res[f"{route} whole dd"] = bound(common + reads + nbytes(dd), n_ops)
    return res


def device_profile(fn, reps, top=6):
    """``torch.profiler`` over ``reps`` calls after a warm-up: the wall time
    a call (with the profiler's overhead), the device time a call summed
    over kernels and copies, the device kernels launched a call, and the
    kernels with the most device time (ms a call)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in rows) / 1e3 / reps
    rows.sort(key=lambda e: -e.self_device_time_total)
    return dict(
        wall_ms=wall * 1e3 / reps, device_busy_ms=busy, idle_share=1.0 - busy / (wall * 1e3 / reps),
        device_launches=sum(e.count for e in rows) / reps,
        top={e.key[:60]: e.self_device_time_total / 1e3 / reps for e in rows[:top]},
    )


def tstep_path(dev, bonsai, teapot, full_hw=(FULL_H, FULL_W), check_hw=(SMALL_H, SMALL_W), train_side=256):
    """Phase 9: the t-step renderers (``make_renderer(..., backend="ray")``:
    ``fast`` to serve, ``diff`` to train), PyTorch ops with no kernel of
    their own, on ``dev`` (the card; the CPU, at small sizes, to rehearse
    it).  Raises on any disagreement; -> the ``tstep`` record."""
    import numpy as np
    import torch

    from volym_tpu_torch import BENCHMARK_PARAMS, Camera, RenderParams, Scene, cli, parity
    from volym_tpu_torch.render import debug_vis, diff, fast, golden
    from volym_tpu_torch.render.renderer import make_renderer

    t_phase = time.perf_counter()
    cuda = dev.type == "cuda"
    fh, fw = full_hw
    rec = {}

    def run(fn):
        """(result, ms by CUDA events, memory in GB:
        ``torch.cuda.max_memory_allocated()`` over the call and what was
        allocated before it) of one call; on the CPU (a rehearsal) no time
        and no memory are measured."""
        if not cuda:
            return fn(), None, None
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        before = torch.cuda.memory_allocated(dev) / 1e9
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        end.synchronize()
        return out, start.elapsed_time(end), dict(peak=torch.cuda.max_memory_allocated(dev) / 1e9, before=before)

    # (a) serving at full width: the 256^3 bonsai with RenderParams() (what
    # `python -m volym_tpu screenshot` renders with no flags), 3 orbit frames
    p = RenderParams()
    render = make_renderer(bonsai, p, fh, fw, backend="ray", device=dev)
    cam = Camera(aspect=fw / fh)
    frames = []
    for _ in range(TSTEP_FRAMES):
        cam = cam.orbit(2.0, 0.0, 0.0)
        cm = cam.matrices(device=dev)
        img, ms, gb = run(lambda: render(cm))
        if not (tuple(img.shape) == (fh, fw, 4) and bool(torch.isfinite(img).all())):
            raise AssertionError(f"t-step frame: shape {tuple(img.shape)} or not finite")
        frames.append(dict(ms=ms, memory_gb=gb))
    cm0 = Camera(aspect=fw / fh).orbit(2.0, 0.0, 0.0).matrices(device=dev)
    frame0 = render(cm0)
    want, golden_ms, golden_gb = run(lambda: golden.render(bonsai, cm0, p, fh, fw))
    if not torch.equal(frame0, want):
        raise AssertionError("t-step frame 0: fast differs from golden")
    stats = {}
    fast.render(bonsai, cm0, p, fh, fw, stats=stats)
    serve = dict(frames=frames, golden_ms=golden_ms, golden_memory_gb=golden_gb, fast_equals_golden=True,
                 steps=stats["steps"], step_bound=stats["step_bound"], resolved_max_steps=p.resolved_max_steps(),
                 lit=float((frame0[..., :3].amax(-1) > 0.01).float().mean()))
    if cuda:
        prof = device_profile(lambda: fast.render(bonsai, cm0, p, fh, fw), 1)
        serve.update(profile=dict(wall_ms=prof["wall_ms"], device_busy_ms=prof["device_busy_ms"],
                                  idle_share=prof["idle_share"], device_launches=prof["device_launches"],
                                  top=prof["top"]))
    log(f"t-step serving bonsai {fh}x{fw}: {json.dumps(serve)}")
    rec["serving_bonsai"] = serve

    # the teapot stand-in with the reference sweep's preset (step .02) as
    # Base, Importance and ImportanceCone: one frame each
    la = {"base": BENCHMARK_PARAMS, "importance": BENCHMARK_PARAMS.replace(use_importance_rendering=True),
          "importance_cone": BENCHMARK_PARAMS.replace(use_importance_rendering=True,
                                                      use_cone_importance_check=True)}
    cmt = Camera(aspect=fw / fh).orbit(30.0, 20.0, 0.0).matrices(device=dev)
    base_img = None
    for name, lp in la.items():
        img, ms, gb = run(lambda: make_renderer(teapot, lp, fh, fw, backend="ray", device=dev)(cmt))
        want, g_ms, g_gb = run(lambda: golden.render(teapot, cmt, lp, fh, fw))
        if not torch.equal(img, want):
            raise AssertionError(f"t-step teapot {name}: fast differs from golden")
        base_img = img if base_img is None else base_img
        differ = float((img != base_img).any(-1).float().mean())
        if name != "base" and not differ > 0:
            raise AssertionError(f"t-step teapot {name}: the look-ahead did not engage")
        row = dict(ms=ms, memory_gb=gb, golden_ms=g_ms, golden_memory_gb=g_gb, differ_from_base=differ)
        log(f"t-step serving teapot {name} {fh}x{fw}: {json.dumps(row)}")
        rec[f"serving_teapot_{name}"] = row

    # (b) the card against the CPU at a small size, by the repo's rule
    ch, cw = check_hw
    cpu = torch.device("cpu")
    agree = {}
    for name, scene, cp, cam_ in [("bonsai default", bonsai, p, Camera(aspect=cw / ch).orbit(2.0, 0.0, 0.0))] + [
            (f"teapot {n}", teapot, lp, Camera(aspect=cw / ch).orbit(30.0, 20.0, 0.0)) for n, lp in la.items()]:
        on_dev = fast.render(scene, cam_.matrices(device=dev), cp, ch, cw).cpu()
        on_cpu = fast.render(scene.to(cpu), cam_.matrices(device=cpu), cp, ch, cw)
        r = parity.check_close(on_cpu, on_dev, f"t-step {name} card vs CPU")
        agree[name] = dict(max_abs_err=r.max_abs_err, bulk_err=r.bulk_err, edge_frac=r.edge_frac,
                           entries_differ=int((on_cpu != on_dev).sum()), entries=on_cpu.numel())
    log(f"t-step card vs CPU at {ch}x{cw}: {json.dumps(agree)}")
    rec["card_vs_cpu"] = agree

    # (c) training: bench.py's config (trilinear, threshold .15, step .005,
    # unshaded, unsmoothed) on the f32 volume, sum(render) through the
    # replay backward, gradients for the volume, the LUT and the camera
    train_p = RenderParams(interpolation="trilinear", density_threshold=0.15, raymarching_step_size=0.005,
                           use_shading=False, use_gaussian_smoothing=False)

    def leaves(scene, coloring=False):
        return Scene(scene.volume.clone().requires_grad_(not coloring),
                     scene.importance.clone().requires_grad_(coloring), scene.tf_lut.clone().requires_grad_(True))

    def camera_leaves(h, w):
        cm = Camera(aspect=w / h, distance=1.0).orbit(30.0, 20.0, 0.0).matrices(device=dev)
        cm.inverse_view_proj.requires_grad_(True)
        cm.position.requires_grad_(True)
        return cm

    def grads(s, cm):
        return {"volume": s.volume.grad, "importance": s.importance.grad, "tf_lut": s.tf_lut.grad,
                "inverse_view_proj": cm.inverse_view_proj.grad, "position": cm.position.grad}

    s = leaves(bonsai)
    train = make_renderer(s, train_p, train_side, train_side, backend="ray", device=dev, differentiable=True)
    steps = []
    for _ in range(TSTEP_TRAIN_STEPS):
        cm = camera_leaves(train_side, train_side)
        for leaf in (s.volume, s.tf_lut):
            leaf.grad = None

        def step():
            img = train(cm)
            img.sum().backward()
            return img

        img, ms, gb = run(step)
        g = grads(s, cm)
        # below a step of .01 the opacity correction's derivative at alpha 1
        # is infinite: a composited sample at the LUT's opaque end gives
        # those entries a non-finite gradient, as in the JAX package
        opaque = torch.from_numpy(parity.opaque_entries(s.tf_lut.detach())).to(dev)
        g_lut = g["tf_lut"]
        bad = [k for k in ("volume", "inverse_view_proj", "position") if not bool(torch.isfinite(g[k]).all())]
        bad += ["tf_lut"] * (not bool(torch.isfinite(g_lut[~opaque]).all()))
        if bad or not float(g["volume"].abs().max()) > 0 or not float(g["position"].abs().max()) > 0:
            raise AssertionError(f"t-step training: gradients not finite ({bad}) or zero")
        steps.append(dict(ms=ms, memory_gb=gb, lut_opaque_end_not_finite=int((~torch.isfinite(g_lut[opaque])).sum())))
    cm = camera_leaves(train_side, train_side)
    sg = leaves(bonsai)
    gp = train_p.replace(adaptive_stepping=False)
    _, autograd_ms, autograd_gb = run(lambda: golden.render(sg, cm, gp, train_side, train_side).sum().backward())
    # step 0's gradients against autograd through the golden at a small size,
    # by tests/test_diff.py's rule (3e-3 of the scale, rtol 2e-2) with the
    # repo's knife-edge accounting: the golden advances t step by step and
    # the replay takes entry + k step, so an ulp apart a sample on the
    # threshold can take the other side of the mask, and the voxels it
    # touches differ by O(the scale); at most TSTEP_KNIFE_EDGE_SHARE of the
    # entries may, each by at most TSTEP_KNIFE_EDGE_ERR of the scale
    # (BASELINE.md: 8 voxels at 64^3)
    held = {}
    res, imgs = [], []
    for fn in (diff.render, golden.render):
        sc, cmc = leaves(bonsai), camera_leaves(ch, cw)
        img = fn(sc, cmc, gp, ch, cw)
        img.sum().backward()
        res.append(grads(sc, cmc))
        imgs.append(img.detach())
    pixel_err = (imgs[0] - imgs[1]).abs().amax(-1)
    held["image"] = dict(max_abs_err=float(pixel_err.max()), pixels_off_by_1e_3=int((pixel_err > 1e-3).sum()))
    if held["image"]["pixels_off_by_1e_3"]:
        raise AssertionError(f"t-step step 0 image: replay vs golden {held['image']}")
    for k in ("volume", "tf_lut", "inverse_view_proj", "position"):
        a, b = res[1][k].cpu().numpy(), res[0][k].cpu().numpy()
        # the LUT's opaque end apart (its derivative can be infinite, and
        # the golden's is NaN where a frozen ray sits on it: C11)
        keep = ~parity.opaque_entries(bonsai.tf_lut) if k == "tf_lut" else np.ones(a.shape, bool)
        a, b = a[keep], b[keep]
        if not (np.isfinite(a).all() and np.isfinite(b).all()):
            raise AssertionError(f"t-step step 0 d {k}: not finite (golden {np.isfinite(a).all()})")
        scale = max(float(np.abs(a).max()), 1e-6)
        off = np.abs(b - a) > 3e-3 * scale + 2e-2 * np.abs(a)
        err_off = float(np.abs(a - b)[off].max()) if off.any() else 0.0
        if off.sum() > TSTEP_KNIFE_EDGE_SHARE * a.size or err_off > TSTEP_KNIFE_EDGE_ERR * scale:
            raise AssertionError(f"t-step step 0 d {k}: {int(off.sum())} of {a.size} entries off the rule, "
                                 f"by up to {err_off:.3e} (scale {scale:.3e})")
        held[k] = dict(scale=scale, entries=int(a.size), knife_edge=int(off.sum()), max_abs_err_off=err_off,
                       max_abs_err_on=float(np.abs(a - b)[~off].max()))
    # one coloring step on the teapot (RenderParams()'s defaults, step .01:
    # the lobster's importance is 1, alpha 1, and below a step of .01 the
    # opacity correction's derivative there is infinite): d_importance
    sc = leaves(teapot, coloring=True)
    cp = RenderParams(use_importance_coloring=True)
    color = make_renderer(sc, cp, train_side, train_side, backend="ray", device=dev, differentiable=True)
    cm = camera_leaves(train_side, train_side)
    _, color_ms, color_gb = run(lambda: color(cm).sum().backward())
    d_imp = sc.importance.grad
    if not (bool(torch.isfinite(d_imp).all()) and float(d_imp.abs().max()) > 0):
        raise AssertionError(f"t-step coloring step: d_importance not finite or zero ({float(d_imp.abs().max())})")
    training = dict(size=f"{train_side}x{train_side}", steps=steps, autograd_golden_ms=autograd_ms,
                    autograd_golden_memory_gb=autograd_gb, step0_vs_autograd_golden=held,
                    coloring_step=dict(ms=color_ms, memory_gb=color_gb))
    log(f"t-step training: {json.dumps(training)}")
    rec["training"] = training

    # (d) the march-length histogram of the (a) frame
    edges, counts = debug_vis.step_count_histogram(bonsai, cm0, p, fh, fw)
    rec["step_count_histogram"] = dict(edges=edges.tolist(), counts=counts.tolist())
    if int(counts.sum()) != fh * fw:
        raise AssertionError("t-step histogram: not every ray counted")

    # the CLI: screenshot --renderer ray renders through fast
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp) / "ray.png"
        argv = ["screenshot", "--renderer", "ray", "--output", str(out)]
        if not cuda:
            argv += ["--device", "cpu", "--side", str(bonsai.volume.shape[0]), "--width", str(fw),
                     "--height", str(fh)]
        rc = cli.main(argv)
        data = out.read_bytes() if out.exists() else b""
        if rc != 0 or data[:8] != b"\x89PNG\r\n\x1a\n":
            raise AssertionError(f"CLI screenshot --renderer ray failed (rc {rc}, {len(data)} bytes)")
        rec["cli_png_bytes"] = len(data)
    rec["wall_s"] = time.perf_counter() - t_phase
    return rec


class LogRecords:
    """Inside it, each message the CLI logs (logger ``volym_tpu_torch``) is
    kept with the launch counts of B1, B6 and B7 when it was logged: a sweep
    logs a line as each row starts, so the counts between two lines are one
    row's."""

    def __init__(self):
        import logging

        self.logger = logging.getLogger("volym_tpu_torch")
        self.records = []
        self.handler = logging.Handler(logging.INFO)
        self.handler.emit = lambda record: self.records.append((record.getMessage(), launch_counts()))

    def __enter__(self):
        import logging

        self.level = self.logger.level
        self.logger.setLevel(logging.INFO)
        self.logger.addHandler(self.handler)
        return self.records

    def __exit__(self, *exc):
        self.logger.removeHandler(self.handler)
        self.logger.setLevel(self.level)


def bench_forward():
    """``bench.py``'s forward frame: trilinear, u8, threshold .15, step .005
    (256 planes at 256^3), unshaded, unsmoothed."""
    from volym_tpu_torch import RenderParams

    return RenderParams(interpolation="trilinear", density_threshold=0.15, raymarching_step_size=0.005,
                        use_shading=False, use_gaussian_smoothing=False, u8_volume=True)


def launch_counts() -> tuple[int, int, int]:
    """The launch counts of B1, B6 and B7."""
    from volym_tpu_torch.ops import lookahead, slab_march

    return slab_march.LAUNCHES, lookahead.STRAIGHT_LAUNCHES, lookahead.CONE_LAUNCHES


def zero_tables() -> None:
    """Set the per-ray and cone tables' launch counts to 0: a main path
    starts."""
    from volym_tpu_torch.ops import ray_table

    ray_table.LAUNCHES = ray_table.CONE_LAUNCHES = 0


def read_tables(path: str, marches: int, cone_gates: int) -> tuple[int, int]:
    """The per-ray and cone tables' kernel launches since :func:`zero_tables`
    on a main path that launched B1 ``marches`` times and B7 ``cone_gates``
    times: one per-ray table a march and one cone table a cone gate, or
    raise (a table built by the chain of PyTorch ops launches none)."""
    from volym_tpu_torch.ops import ray_table

    got = (ray_table.LAUNCHES, ray_table.CONE_LAUNCHES)
    if got != (marches, cone_gates):
        raise AssertionError(f"{path}: (per-ray table, cone table) launches {got}, expected {(marches, cone_gates)}")
    return got


def table_path(dev, full_hw=(FULL_H, FULL_W)) -> dict:
    """Phase 4b: the per-ray and cone tables' kernels (csrc/ray_table.cu)
    against their plain version, the chain of PyTorch ops
    (``slab_march.table_chain``), at full size: every march axis and sign
    (``ORBITS``), 128 planes with a slice of 128 and of 48 rows, with and
    without the cone; bit for bit, NaN in the same places.  Then each
    kernel's ms, the chain's and the bound (a ray reads its NDC point, 8
    bytes, and writes 15 or 56 float32 rows).  -> {kernel: its row}"""
    import torch

    from volym_tpu_torch import Camera
    from volym_tpu_torch.ops import ray_table, slab_march
    from volym_tpu_torch.render import rays as rays_mod
    from volym_tpu_torch.render import slab

    h, w = full_hw
    ndc = rays_mod.pixel_ndc(h, w, dev)
    cams = [Camera(aspect=w / h, distance=1.3).orbit(a, b, 0.0).matrices().to(dev) for a, b in ORBITS]
    axes = {slab.dominant_axis(cm) for cm in cams}
    if len(axes) != 6:
        raise AssertionError(f"the orbits march along {sorted(axes)}, not every axis and sign")
    for cm in cams:
        major, sign = slab.dominant_axis(cm)
        for n_plane in (128, 48):
            for cone in (False, True):
                got = ray_table.table_cuda(cm.inverse_view_proj, cm.position, ndc, 128, major, sign, n_plane,
                                           cone=cone)
                want = slab_march.table_chain(cm, ndc, 128, major, sign, n_plane, cone)
                nan = torch.isnan(want)
                if not (torch.equal(nan, torch.isnan(got)) and torch.equal(want[~nan], got[~nan])):
                    raise AssertionError(f"{'cone' if cone else 'per-ray'} table (axis {major}, sign {sign}, "
                                         f"n_plane {n_plane}) differs from the chain's")
    cm = cams[0]
    major, sign = slab.dominant_axis(cm)
    rows = {}
    for name, cone, n_rows in (("ray_table", False, slab.N_FEATURES), ("cone_table", True, slab.CONE_FEATURES)):
        ms = cuda_ms(lambda cone=cone: ray_table.table_cuda(cm.inverse_view_proj, cm.position, ndc, 128, major, sign,
                                                            128, cone=cone), 20)
        plain_ms = cuda_ms(lambda cone=cone: slab_march.table_chain(cm, ndc, 128, major, sign, 128, cone), 5)
        bound_ms, bound_by = bound(h * w * (8 + 4 * n_rows), 0)
        rows[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)
    log(f"tables at {h}x{w}: kernels == chain bit for bit in {len(cams) * 4} cases; {json.dumps(rows)}")
    return rows


def cli_path(dev, bonsai, full_hw=(FULL_H, FULL_W), fit_side=256, cli_side=FULL_SIDE):
    """Phase 10: the CLI's ``benchmark``, ``fit`` and ``run --live-sweep``,
    the harness's host clock and ``fit_scene``, on ``dev`` (the card; the
    CPU, at small sizes and through the plain march, to rehearse it, where
    no launch is counted, no time or memory is measured and the profiler
    trace is not searched).  Raises on any failure; -> (the ``cli`` record,
    the sweep's launches of B1, B6 and B7)."""
    import csv
    import math
    import os
    import re

    import torch

    from volym_tpu_torch import Camera, Scene, cli
    from volym_tpu_torch import io as vio
    from volym_tpu_torch.bench import harness
    from volym_tpu_torch.ops import lookahead, slab_march
    from volym_tpu_torch.optim import fit_scene
    from volym_tpu_torch.render import golden
    from volym_tpu_torch.render.renderer import make_renderer

    t_phase = time.perf_counter()
    cuda = dev.type == "cuda"
    fh, fw = full_hw
    where = [] if cuda else ["--device", "cpu", "--renderer", "slab", "--side", str(cli_side), "--width", str(fw),
                             "--height", str(fh)]
    rec = {}

    def run_cli(argv):
        with LogRecords() as records:
            rc = cli.main(argv)
        if rc != 0:
            raise AssertionError(f"CLI {argv}: rc {rc}")
        return records

    def read_rows(path):
        with open(path, newline="") as f:
            reader = csv.DictReader(f)
            if reader.fieldnames != harness.CSV_FIELDS + ["rays_per_s"]:
                raise AssertionError(f"sweep CSV: columns {reader.fieldnames}")
            return list(reader)

    with tempfile.TemporaryDirectory() as tmp:
        # (a) the sweep through the CLI at step .005: Base, Importance and
        # ImportanceCone at 3 look-aheads each, 1 trial of 0.25 s a row.  The
        # counts start at 0 here and are read when it ends: its main path
        out = Path(tmp) / "sweep.csv"
        slab_march.LAUNCHES = lookahead.STRAIGHT_LAUNCHES = lookahead.CONE_LAUNCHES = 0
        zero_tables()
        records = run_cli(["benchmark", "--trials", "1", "--seconds", "0.25", "--sweep-steps", "0.005",
                           "--output", str(out), *where])
        sweep_launches = launch_counts()
        sweep_tables = read_tables("cli sweep", sweep_launches[0], sweep_launches[2])
        rows = read_rows(out)
        starts = [c for msg, c in records if msg.startswith("benchmark ")]
        if len(rows) != 7 or len(starts) != 7:
            raise AssertionError(f"sweep: {len(rows)} rows, {len(starts)} started")
        sweep = []
        for row, c0, c1 in zip(rows, starts, starts[1:] + [sweep_launches]):
            b1, b6, b7 = (b - a for a, b in zip(c0, c1))
            frames = float(row["avg_total_frames"])
            kind = row["algorithm"]
            if not float(row["rays_per_s"]) > 0:
                raise AssertionError(f"sweep {kind}: rays/s {row['rays_per_s']}")
            # B1 in every row, B6 only in the Importance rows, B7 only in the
            # ImportanceCone rows, each at least once a counted frame
            gated = (True, kind == "Importance", kind == "ImportanceCone")
            if cuda and not all(n >= frames if on else n == 0 for n, on in zip((b1, b6, b7), gated)):
                raise AssertionError(f"sweep {kind} ahead {row['importance_steps']}: {frames} frames, "
                                     f"B1/B6/B7 launches {(b1, b6, b7)}")
            sweep.append(dict(algorithm=kind, step=float(row["step_size"]), ahead=int(row["importance_steps"]),
                              frame_ms=float(row["avg_frame_time_ms"]),
                              frame_ms_std=float(row["std_dev_frame_time_ms"]), frames=frames,
                              rays_per_s=float(row["rays_per_s"]), launches=dict(B1=b1, B6=b6, B7=b7)))
            log(f"cli sweep {fh}x{fw}: {json.dumps(sweep[-1])}")
        rec["sweep"] = sweep

        # (b) the sweep at step .02 under --profile: the trace names B1
        prof_dir = Path(tmp) / "profile"
        run_cli(["benchmark", "--trials", "1", "--seconds", "0.1", "--sweep-steps", "0.02", "--output",
                 str(Path(tmp) / "profiled.csv"), "--profile", str(prof_dir), *where])
        trace = (prof_dir / "trace.json").read_bytes()
        if cuda and b"slab_march_kernel" not in trace:
            raise AssertionError("benchmark --profile: the trace does not name slab_march_kernel")
        rec["profile"] = dict(trace_mb=len(trace) / 1e6, names_slab_march_kernel=b"slab_march_kernel" in trace)
        log(f"cli benchmark --profile: {json.dumps(rec['profile'])}")
        del trace

    # (c) the harness's host clock on bench.py's forward frame
    render = make_renderer(bonsai, bench_forward(), fh, fw, backend="slab_cuda" if cuda else "slab", device=dev)
    cm = Camera(aspect=fw / fh).orbit(2.0, 0.0, 0.0).matrices()
    marginal_ms = harness.marginal_time(lambda: render(cm)) * 1e3
    if not marginal_ms > 0:
        raise AssertionError(f"bench frame: marginal {marginal_ms} ms")
    rec["bench_frame"] = dict(marginal_ms=marginal_ms)
    log(f"bench frame {fh}x{fw}, host clock: {json.dumps(rec['bench_frame'])}")

    # (d) fit_scene at full width: the bonsai, fit_side^2 rays, the CLI fit's
    # parameters, FIT_STEPS steps, each timed by CUDA events
    fit_p = cli._params(cli.build_parser().parse_args(["fit"])).replace(
        adaptive_stepping=False, camera_grads=False, u8_volume=False)
    cm = Camera().matrices(device=dev)
    target = golden.render(bonsai, cm, fit_p, fit_side, fit_side)
    init = Scene(torch.full_like(bonsai.volume, max(0.15, fit_p.density_threshold + 0.03)), bonsai.importance,
                 bonsai.tf_lut)
    events = []

    def mark(*_):
        if cuda:
            events.append(torch.cuda.Event(enable_timing=True))
            events[-1].record()

    before = None
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        before = torch.cuda.memory_allocated(dev)
    mark()
    res = fit_scene(init, cm, target, fit_p, steps=FIT_STEPS, callback=mark)
    losses = res.losses
    if not (all(map(math.isfinite, losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"fit_scene: the loss did not fall ({losses})")
    fit = dict(size=f"{fit_side}x{fit_side}", side=int(bonsai.volume.shape[0]), losses=losses)
    if cuda:
        torch.cuda.synchronize()
        fit.update(step_ms=[a.elapsed_time(b) for a, b in zip(events, events[1:])],
                   peak_memory_gb=(torch.cuda.max_memory_allocated(dev) - before) / 1e9)
    rec["fit_scene"] = fit
    log(f"fit_scene: {json.dumps(fit)}")

    with tempfile.TemporaryDirectory() as tmp:
        # (e) fit through the CLI at a small size: the sphere at 32^3, 64x64,
        # 10 steps, threshold .05, unsmoothed
        npz = Path(tmp) / "fitted.npz"
        records = run_cli(["fit", "--scene", "sphere", "--side", "32", "--width", "64", "--height", "64", "--frames",
                           "10", "--threshold", "0.05", "--no-gaussian", "--output", str(npz),
                           *(["--device", "cpu"] if not cuda else [])])
        (first, last), = [tuple(map(float, m.groups())) for msg, _ in records
                          if (m := re.fullmatch(r"loss: (\S+) -> (\S+)", msg))]
        ckpt = vio.load_checkpoint(npz)
        lut_shape = tuple(Scene.synthetic("sphere", side=8).tf_lut.shape)
        if not (math.isfinite(last) and last < first and ckpt["volume"].shape == (32, 32, 32)
                and ckpt["tf_lut"].shape == lut_shape):
            raise AssertionError(f"CLI fit: loss {first} -> {last}, checkpoint "
                                 f"{ {k: v.shape for k, v in ckpt.items()} }")
        rec["cli_fit"] = dict(loss_first=first, loss_last=last, volume=list(ckpt["volume"].shape),
                              tf_lut=list(ckpt["tf_lut"].shape))
        log(f"cli fit: {json.dumps(rec['cli_fit'])}")

        # (f) run --renderer ray --live-sweep: 3 frames at 96x64, the last saved
        cwd = os.getcwd()
        os.chdir(tmp)
        try:
            run_cli(["run", "--renderer", "ray", "--live-sweep", "--frames", "3", "--width", "96", "--height", "64",
                     *(["--device", "cpu", "--side", str(cli_side)] if not cuda else [])])
        finally:
            os.chdir(cwd)
        pngs = list(Path(tmp).glob("screenshot_*.png"))
        if len(pngs) != 1 or pngs[0].read_bytes()[:8] != b"\x89PNG\r\n\x1a\n":
            raise AssertionError(f"run --live-sweep: wrote {pngs}")
        rec["live_sweep_png_bytes"] = pngs[0].stat().st_size

    rec["wall_s"] = time.perf_counter() - t_phase
    return rec, (*sweep_launches, *sweep_tables)


def all_launches() -> dict:
    """The launch count of every kernel's wrapper, by the summary's names
    (B3 and B4 as the fused fold-and-scatter and the scatter alone)."""
    from volym_tpu_torch.ops import feats_grad, lookahead, ray_table, slab_march, slab_replay, voxel_grad

    return dict(slab_march=slab_march.LAUNCHES, slab_replay=slab_replay.LAUNCHES,
                lookahead_straight=lookahead.STRAIGHT_LAUNCHES, lookahead_cone=lookahead.CONE_LAUNCHES,
                voxel_grad=voxel_grad.FOLD_LAUNCHES + voxel_grad.LAUNCHES,
                voxel_grad_shaded=voxel_grad.FOLD_SHADED_LAUNCHES + voxel_grad.SHADED_LAUNCHES,
                feats_grad=feats_grad.LAUNCHES, ray_table=ray_table.LAUNCHES, cone_table=ray_table.CONE_LAUNCHES)


def zero_launches() -> None:
    from volym_tpu_torch.ops import feats_grad, lookahead, slab_march, slab_replay, voxel_grad

    slab_march.LAUNCHES = slab_replay.LAUNCHES = feats_grad.LAUNCHES = 0
    lookahead.STRAIGHT_LAUNCHES = lookahead.CONE_LAUNCHES = 0
    voxel_grad.LAUNCHES = voxel_grad.SHADED_LAUNCHES = voxel_grad.FOLD_LAUNCHES = voxel_grad.FOLD_SHADED_LAUNCHES = 0
    zero_tables()


def distributed_path(dev, bonsai, teapot, full_hw=(FULL_H, FULL_W), train_hw=(256, 256), cli_side=FULL_SIDE):
    """Phase 11: distribution and the viewer, :func:`distributed_path`, on
    ``dev`` (the card, under a one-rank NCCL group; the CPU, through the
    plain march under a gloo group, at small sizes, to rehearse it, where
    no launch is counted and no time is taken).  Raises on any failure;
    -> (the ``distributed`` record, the phase's launches by kernel)."""
    import math
    import re
    import threading
    import urllib.request
    from datetime import timedelta

    import torch
    import torch.distributed as dist

    from volym_tpu_torch import BENCHMARK_PARAMS, Camera, RenderParams, Scene, cli, parity, viewer
    from volym_tpu_torch import io as vio
    from volym_tpu_torch.parallel import launch
    from volym_tpu_torch.parallel import mesh as pmesh
    from volym_tpu_torch.render.renderer import make_renderer

    t_phase = time.perf_counter()
    cuda = dev.type == "cuda"
    backend = "slab_cuda" if cuda else "slab"
    fh, fw = full_hw
    th, tw = train_hw
    rec = {}
    timed = cuda_ms if cuda else (lambda fn, reps: (fn(), None)[1])
    # the main path starts here: every count at 0, read when the phase ends
    zero_launches()
    # (a) a one-rank group through the bootstrap (env={}: a world of one)
    if not launch.maybe_initialize(True, device=dev.type, timeout=timedelta(seconds=120), env={}):
        raise AssertionError("maybe_initialize did not bring up the group")
    try:
        rec["group"] = dict(backend=str(dist.get_backend()), world=dist.get_world_size())
        log(f"distributed: {json.dumps(rec['group'])}")

        # (b) sharded frames against the single-device frame, bit for bit;
        # B1 (and B7) once a shard
        frame_cells = {
            "bonsai cli_default_gaussian": (bonsai, cli._params(cli.build_parser().parse_args(["screenshot"]))),
            "teapot importance_cone": (teapot, BENCHMARK_PARAMS.replace(
                raymarching_step_size=0.005, u8_volume=True, use_importance_rendering=True,
                use_cone_importance_check=True)),
        }
        cm = Camera(aspect=fw / fh).orbit(30.0, 20.0, 0.0).matrices()
        rec["frames"] = {}
        for name, (sc, p) in frame_cells.items():
            render = make_renderer(sc, p, fh, fw, backend=backend, device=dev)
            want = render(cm)
            row = dict(single_ms=timed(lambda: render(cm), 5))
            for shards in (1, 4):
                mesh = pmesh.make_mesh([dev] * shards)
                before = all_launches()
                got = pmesh.render_sharded(sc, cm, p, fh, fw, mesh, backend=backend)
                if cuda:
                    torch.cuda.synchronize()
                b1, b7 = (all_launches()[k] - before[k] for k in ("slab_march", "lookahead_cone"))
                if cuda and (b1, b7) != (shards, shards if p.use_cone_importance_check else 0):
                    raise AssertionError(f"sharded {name}, {shards} shards: B1/B7 launches {(b1, b7)}")
                if not torch.equal(got, want):
                    raise AssertionError(f"sharded {name}, {shards} shards: {int((got != want).sum())} entries differ "
                                         "from the single-device frame")
                row[f"{shards}_shards_ms"] = timed(
                    lambda: pmesh.render_sharded(sc, cm, p, fh, fw, mesh, backend=backend), 5)
                row[f"{shards}_shards_launches"] = dict(B1=b1, B7=b7)
            rec["frames"][name] = row
            log(f"distributed frame {name} {fh}x{fw}, bit for bit at 1 and 4 shards: {json.dumps(row)}")

        # (c) the sharded train step against the single-device step
        step_cells = {
            "bench": RenderParams(interpolation="trilinear", density_threshold=0.15, raymarching_step_size=0.005,
                                  use_shading=False, use_gaussian_smoothing=False, u8_volume=True,
                                  camera_grads=False),
            "bench_gaussian camera": RenderParams(interpolation="trilinear", density_threshold=0.15,
                                                  raymarching_step_size=0.005, use_shading=False, u8_volume=True),
        }
        cm = Camera(aspect=tw / th, distance=1.0).orbit(30.0, 20.0, 0.0).matrices()
        rec["steps"] = {}
        for name, p in step_cells.items():
            fixed = p.replace(adaptive_stepping=False, u8_volume=False)
            target = make_renderer(bonsai, p, th, tw, backend=backend, device=dev)(cm).detach() * 0.8
            leaves = Scene(*(t.detach().clone().requires_grad_() for t in (bonsai.volume, bonsai.importance,
                                                                             bonsai.tf_lut)))
            single = make_renderer(leaves, fixed, th, tw, backend=backend, device=dev, differentiable=True)

            def single_step():
                leaves.volume.grad = leaves.tf_lut.grad = leaves.importance.grad = None
                loss = torch.mean((single(cm) - target) ** 2)
                loss.backward()
                return loss

            ref = single_step().detach()
            first_grads = (leaves.volume.grad.clone(), leaves.tf_lut.grad.clone())
            # B2 sums by float atomics, whose order may vary from run to run:
            # the single-device step again on the same inputs, against its first run
            reruns = dict(runs=8, loss_differs=0, d_volume_differs=0, d_lut_differs=0, d_volume_max_abs_diff=0.0)
            for _ in range(reruns["runs"]):
                again = single_step().detach()
                reruns["loss_differs"] += not torch.equal(again, ref)
                reruns["d_volume_differs"] += not torch.equal(leaves.volume.grad, first_grads[0])
                reruns["d_lut_differs"] += not torch.equal(leaves.tf_lut.grad, first_grads[1])
                reruns["d_volume_max_abs_diff"] = max(reruns["d_volume_max_abs_diff"], float(
                    (leaves.volume.grad - first_grads[0]).abs().max()))
            row = dict(single_ms=timed(single_step, 3), single_reruns=reruns)
            for shards in (1, 4):
                step = pmesh.make_train_step(p, th, tw, pmesh.make_mesh([dev] * shards), backend=backend,
                                             camera_matrices=cm)
                before = all_launches()
                loss, grads = step(bonsai, cm, target)
                launched = {k: v - before[k] for k, v in all_launches().items() if v != before[k]}
                # the camera cell: B3's fold with B5 fused in, once a shard
                fused = (launched.get("voxel_grad", 0), launched.get("feats_grad", 0))
                if cuda and p.camera_grads and fused != (shards, shards):
                    raise AssertionError(f"sharded step {name}, {shards} shards: (B3, B5) launches {fused}")
                if not math.isclose(float(loss), float(ref), rel_tol=1e-5):
                    raise AssertionError(f"sharded step {name}, {shards} shards: loss {float(loss)} vs {float(ref)}")
                vol = parity.check_close(leaves.volume.grad, grads.volume, f"sharded step {name} d_volume")
                lut, _ = parity.check_lut_grad(leaves.tf_lut.grad, grads.tf_lut, bonsai.tf_lut,
                                               f"sharded step {name} d_lut")
                if bool(grads.importance.any()) or not float(grads.volume.abs().max()) > 0:
                    raise AssertionError(f"sharded step {name}: d_importance nonzero or d_volume zero")
                row[f"{shards}_shards_ms"] = timed(lambda: step(bonsai, cm, target), 3)
                row[f"{shards}_shards"] = dict(launches=launched, d_volume_max_abs_err=vol.max_abs_err,
                                               d_volume_edge_frac=vol.edge_frac, d_lut_max_abs_err=lut.max_abs_err)
            rec["steps"][name] = row
            log(f"distributed step {name} {th}x{tw}: {json.dumps(row)}")

        # (d) the all-reduce of a 256^3 d_volume (67 MB)
        d_vol = torch.ones(bonsai.volume.shape, dtype=torch.float32, device=dev)
        rec["all_reduce"] = dict(mb=nbytes(d_vol) / 1e6, ms=timed(lambda: dist.all_reduce(d_vol), 20))
        log(f"distributed all_reduce of d_volume: {json.dumps(rec['all_reduce'])}")

        # (e) fit_distributed, 5 steps from a flat volume
        p = step_cells["bench"]
        target = make_renderer(bonsai, p, th, tw, backend=backend, device=dev)(cm).detach()
        init = Scene(torch.full_like(bonsai.volume, 0.18), bonsai.importance, bonsai.tf_lut)
        _, losses = launch.fit_distributed(init, cm, target, p.replace(u8_volume=False), steps=5, backend=backend)
        if not (all(map(math.isfinite, losses)) and losses[-1] < losses[0]):
            raise AssertionError(f"fit_distributed: the loss did not fall ({losses})")
        rec["fit_distributed"] = losses
        log(f"fit_distributed {th}x{tw}: losses {losses}")

        with tempfile.TemporaryDirectory() as tmp:
            # (f) the CLI: fit --distributed and benchmark --scaling
            where = [] if cuda else ["--device", "cpu", "--renderer", "slab"]
            npz = Path(tmp) / "fitted.npz"
            with LogRecords() as records:
                rc = cli.main(["fit", "--distributed", "--scene", "sphere", "--side", "32", "--width", "64",
                               "--height", "64", "--frames", "10", "--threshold", "0.05", "--no-gaussian",
                               "--output", str(npz), *where])
            (first, last), = [tuple(map(float, m.groups())) for msg, _ in records
                              if (m := re.fullmatch(r"loss: (\S+) -> (\S+)", msg))]
            if rc != 0 or not last < first or vio.load_checkpoint(npz)["volume"].shape != (32, 32, 32):
                raise AssertionError(f"CLI fit --distributed: rc {rc}, loss {first} -> {last}")
            out = Path(tmp) / "scaling.csv"
            rc = cli.main(["benchmark", "--scaling", "--trials", "1", "--seconds", "0.25", "--side", str(cli_side),
                           "--width", str(fw), "--height", str(fh), "--output", str(out), *where])
            rows = out.read_text().splitlines()
            if rc != 0 or len(rows) != 2 or not rows[0].endswith("devices,rays_per_s,scaling_efficiency"):
                raise AssertionError(f"CLI benchmark --scaling: rc {rc}, {rows}")
            row = dict(zip(rows[0].split(","), rows[1].split(",")))
            rec["cli"] = dict(fit_loss=[first, last], scaling={k: row[k] for k in (
                "devices", "avg_frame_time_ms", "rays_per_s", "scaling_efficiency")})
            log(f"distributed cli: {json.dumps(rec['cli'])}")

            # (g) the viewer on 127.0.0.1:0 in a thread: /frame is the
            # renderer's frame, and one /screenshot
            p = frame_cells["bonsai cli_default_gaussian"][1]
            srv = viewer.make_server(bonsai, p, fh, fw, port=0, screenshot_dir=tmp, backend=backend, device=dev)
            thread = threading.Thread(target=srv.serve_forever, daemon=True)
            thread.start()
            try:
                host, port = srv.server_address
                query = "h=30&v=20&dist=1.2"
                got, render_ms = [], []
                for _ in range(4):
                    with urllib.request.urlopen(f"http://{host}:{port}/frame?{query}", timeout=120) as r:
                        got.append(r.read())
                        render_ms.append(float(r.headers["X-Render-Ms"]))
                with urllib.request.urlopen(f"http://{host}:{port}/screenshot?{query}", timeout=120) as r:
                    shot = Path(json.loads(r.read())["path"])
            finally:
                srv.shutdown()
                srv.server_close()
                thread.join(timeout=60)
            q = {k: [v] for k, v in (kv.split("=") for kv in query.split("&"))}
            want = make_renderer(bonsai, p, fh, fw, backend=backend, device=dev)(
                viewer.camera_from_query(q, fw / fh).matrices())
            if got[0] != vio.png_bytes(want) or len(set(got)) != 1:
                raise AssertionError("viewer: /frame is not the renderer's frame")
            if thread.is_alive() or shot.read_bytes()[:8] != b"\x89PNG\r\n\x1a\n":
                raise AssertionError(f"viewer: thread alive {thread.is_alive()}, screenshot {shot}")
            rec["viewer"] = dict(frame_ms=render_ms[1:] if cuda else None, png_bytes=len(got[0]),
                                 screenshot_bytes=shot.stat().st_size)
            log(f"distributed viewer {fh}x{fw}: {json.dumps(rec['viewer'])}")
    finally:
        dist.destroy_process_group()
    launches = all_launches()  # the main path ends here
    # B5 runs fused into B3's fold: each of its launches is one of B3's
    if cuda and not (all(launches[k] > 0 for k in ("slab_march", "slab_replay", "lookahead_cone", "voxel_grad",
                                                   "feats_grad")) and launches["voxel_grad"] >= launches["feats_grad"]):
        raise AssertionError(f"phase 11 launches: {launches}")
    if cuda:
        read_tables("phase 11", launches["slab_march"], launches["lookahead_cone"])
    rec["launches"] = launches
    rec["wall_s"] = time.perf_counter() - t_phase
    return rec, launches


class NoTranspose:
    """Inside it, the plain transpose of the smoothing stencil and the plain
    rows' plain camera chain raise on CUDA tensors: the smoothed backward on
    the card must run the fused kernel (with its chain) instead."""

    NAMES = ("smooth_dd_transpose", "feats_grad")

    def __enter__(self):
        from volym_tpu_torch.render import slab

        self._slab, self._plain = slab, {name: getattr(slab, name) for name in self.NAMES}

        def guard(name):
            def fn(feats, *args, **kwargs):
                if feats.device.type == "cuda":
                    raise AssertionError(f"the plain {name} ran on CUDA tensors on the main path")
                return self._plain[name](feats, *args, **kwargs)
            return fn

        for name in self.NAMES:
            setattr(slab, name, guard(name))
        return self

    def __exit__(self, *exc):
        for name, fn in self._plain.items():
            setattr(self._slab, name, fn)
        return False


def unfold(feats, dd, vol_shape, params):
    """The replay's per-step cotangents with the density channel folded onto
    the plain rows by the plain transpose, the other channels as they are:
    what the scatter without the fold (B3/B4's other variant) takes."""
    import torch

    from volym_tpu_torch.render import slab

    _, nr, nc = vol_shape
    bilinear = params.interpolation.value == "trilinear"
    if dd.dim() == 4:
        return torch.cat([slab.smooth_dd_transpose(feats, dd[:, 0], nr, nc, bilinear)[:, None], dd[:, 1:]], dim=1)
    return slab.smooth_dd_transpose(feats, dd, nr, nc, bilinear)


def stencil_steps(feats, vol, sign, params, threshold, sampled) -> int:
    """The sampled steps (``sampled``, (N, rays) bool) whose smoothing
    stencil can reach ``threshold``.  The march without the residual and
    the re-sampled replay skip, exactly, the stencil of a step whose 7
    plain rows all lie below it (``sample_bound`` in csrc/slab_common.cuh),
    so only these steps count toward their operations bounds."""
    import torch

    from volym_tpu_torch.render import slab

    rows = slab._stencil_rows(feats.reshape(slab.N_FEATURES, -1), vol, sign, params)
    top = rows[0]
    for row in rows[1:]:
        top = torch.maximum(top, row)
    del rows
    return int((sampled.reshape(top.shape) & (top.clamp_min(0.0) * (1.0 + 2.0**-16) >= threshold)).sum())


def ptxas_report(log_text: str) -> dict:
    """Each kernel's registers and spill bytes from nvcc's ``-Xptxas -v``
    output: {kernel: [registers, spill stores + loads]}, the kernel named by
    its function and its template arguments (1/0 for each bool, the value of
    an int: the march's colour mode)."""
    report, name = {}, None
    for line in log_text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            mangled = m.group(1)
            fn = re.search(r"\d+(slab_march_kernel|slab_replay_kernel_bounded|slab_replay_kernel|important_bounds_kernel"
                           r"|lookahead_kernel|voxel_grad_chain_kernel|voxel_grad_kernel)", mangled)
            args = "".join(re.findall(r"L[bi](\d+)E", mangled))
            name = (fn.group(1) if fn else mangled[:40]) + (f"<{args}>" if args else "")
            report[name] = [0, 0]
        elif name and "bytes spill" in line:
            report[name][1] = sum(int(x) for x in re.findall(r"(\d+) bytes spill", line))
        elif name and "Used" in line:
            report[name][0] = int(re.search(r"Used (\d+) registers", line).group(1))
    if not report:
        raise AssertionError("no ptxas report in nvcc's output")
    return report


def important_bounds(levels):
    """Each slice's important texels (level >= 1), as the gate kernels'
    bounds pass finds them -> (has (N,) bool, first row, last row, first
    column, last column (N,) int64; n / -1 where the slice has none)."""
    import torch

    def ends(mask):  # (N, m) bool -> first and last True index
        idx = torch.arange(mask.shape[1], device=mask.device)
        return torch.where(mask, idx, mask.shape[1]).amin(1), torch.where(mask, idx, -1).amax(1)

    imp = levels >= 1
    rows_any, cols_any = imp.any(2), imp.any(1)
    return (rows_any.any(1), *ends(rows_any), *ends(cols_any))


def important_span(levels) -> dict:
    """The slices of a level grid with important texels (level >= 1), and
    the mean share of such a slice that the rows x columns of those texels
    span: what the gate kernels' bounds pass leaves them to tap."""
    has, r0, r1, c0, c1 = important_bounds(levels)
    if not bool(has.any()):
        return dict(important_slices=0, important_span_share=0.0)
    span = ((r1 - r0 + 1) * (c1 - c0 + 1))[has]
    return dict(important_slices=int(has.sum()),
                important_span_share=float(span.float().mean()) / (levels.shape[1] * levels.shape[2]))


def staged_pairs(feats, vol, grad, u8, params, stop=None) -> dict:
    """How the CUDA march's (block, batch) pairs that read densities split
    between the staged and the direct route on these inputs, from the
    transcription of its plan (``slab_march.stage_plan``; without ``stop``
    every ray marches to its exit, which makes the windows the largest the
    kernel can plan)."""
    from volym_tpu_torch.ops import slab_march

    aligned = all(t is None or (t.data_ptr() % 16 == 0 and t.shape[-1] * t.element_size() % 16 == 0)
                  for t in (vol, grad))
    staged, direct = slab_march.stage_plan(feats, vol.shape, u8, params, stop=stop, can_stage=aligned).counts()
    return dict(staged=staged, direct=direct, staged_share=staged / max(staged + direct, 1))


class KernelSwap:
    """Inside it, ``module``'s wrapper launches ``fn``, the C entry of
    another build of its kernel, instead of its own."""

    def __init__(self, module, fn):
        self.module, self.fn = module, fn

    def __enter__(self):
        self.own = self.module._library
        self.module._library = lambda: self.fn
        return self

    def __exit__(self, *exc):
        self.module._library = self.own
        return False


class Before:
    """The march (B1), replay (B2), gate (B6, B7) and fold-and-scatter (B3,
    B4) kernels built from another checkout's sources (``--parent DIR``),
    launched through this checkout's wrappers on the same inputs, so that a
    kernel's time before a change sits beside its time after it, in one
    process on one card.  The C entries take the same arguments.  The
    replay's ``dd`` is allocated as that checkout's wrapper allocates it:
    zero-filled, unless its ``ops/slab_replay.py`` allocates with
    ``ALLOC_DD = torch.empty`` (its kernel then writes each ray's step
    range), so the zero-fill a parent's kernel needs counts in its time.  A
    checkout with ``csrc/feats_grad.cu`` computes the plain rows' camera
    chain (B5) as its own kernel over a zero-filled tensor of folded rows
    that its fold writes (:meth:`chain`); one without it, fused into the
    fold."""

    NAMES = ("slab_march", "lookahead", "slab_replay", "voxel_grad")

    def __init__(self, root):
        import torch

        root = Path(root).resolve()
        self.label = root.name
        self.csrc = root / "volym_tpu_torch" / "ops" / "csrc"
        if not all((self.csrc / f"{n}.cu").exists() for n in self.NAMES):
            raise SystemExit(f"chip_smoke: --parent {root} holds no volym_tpu_torch/ops/csrc/"
                             f"{{{','.join(self.NAMES)}}}.cu")
        self.names = self.NAMES + (("feats_grad",) if (self.csrc / "feats_grad.cu").exists() else ())
        wrapper = (root / "volym_tpu_torch" / "ops" / "slab_replay.py").read_text()
        self.alloc_dd = torch.empty if "ALLOC_DD = torch.empty" in wrapper else torch.zeros
        self.fns = {}
        self.b5 = None

    def build(self, name):
        from volym_tpu_torch.ops import _build

        return _build.build(name, self.csrc)

    def load(self, builds):
        from volym_tpu_torch.ops import lookahead, slab_march, slab_replay, voxel_grad

        self.modules = {"slab_march": slab_march, "lookahead": lookahead, "slab_replay": slab_replay,
                        "voxel_grad": voxel_grad}
        for name, built in builds.items():
            lib = ctypes.CDLL(str(built.path))
            if name == "feats_grad":  # its C entry as that checkout's wrapper bound it
                fn = self.b5 = lib.feats_grad_launch
                fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_longlong, ctypes.c_void_p]
                fn.restype = ctypes.c_int
            else:
                self.fns[name] = self.modules[name]._bind(lib)

    def ms(self, name, fn, reps, alloc_dd=None):
        """``cuda_ms`` of ``fn`` with the module ``name``'s kernel swapped
        for the other checkout's (and, for the replay, ``dd`` allocated by
        ``alloc_dd``, by default as that checkout's wrapper does)."""
        from volym_tpu_torch.ops import slab_replay

        own_alloc = slab_replay.ALLOC_DD
        slab_replay.ALLOC_DD = alloc_dd or self.alloc_dd
        try:
            with KernelSwap(self.modules[name], self.fns[name]):
                return cuda_ms(fn, reps)
        finally:
            slab_replay.ALLOC_DD = own_alloc

    def scatter_fn(self, feats, dd, steps, vol_shape, sign, params, want_folded=False):
        """That checkout's fold-and-scatter, as ``smooth_backward``'s
        ``scatter_fn`` (the folded rows when asked)."""
        from volym_tpu_torch.ops import voxel_grad

        with KernelSwap(voxel_grad, self.fns["voxel_grad"]):
            return voxel_grad.fold_scatter_cuda(feats, dd, steps, vol_shape, sign, params, want_folded)

    def feats_grad_fn(self, feats, vol, folded, sign, params):
        """That checkout's own B5 (``csrc/feats_grad.cu``) on the (N, H, W)
        folded rows, as ``smooth_backward``'s ``feats_grad_fn``."""
        import torch

        d_feats = torch.zeros_like(feats)
        n, nr, nc = vol.shape
        rc = self.b5(feats.data_ptr(), vol.data_ptr(), folded.data_ptr(), d_feats.data_ptr(), feats.shape[1],
                     feats.shape[2], n, nr, nc, int(sign), int(params.subtexel_bits), folded.stride(0),
                     torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"--parent {self.label} feats_grad launch failed with CUDA error {rc}")
        return d_feats

    def chain(self, feats, dd, steps, vol, sign, params):
        """That checkout's smoothed backward with the plain rows' camera
        chain on these inputs -> (d_vol, d_grad, d_feats) and its parts'
        functions (``{part: fn}``, to time): with its own B5, the zero-fill
        of the (N, H, W) folded rows, its fold writing them (the wrapper's
        zero-fills included) and B5 reading them; without, its fused
        chain."""
        import torch

        from volym_tpu_torch.ops import voxel_grad

        if self.b5 is None:
            def fused():
                with KernelSwap(voxel_grad, self.fns["voxel_grad"]):
                    return voxel_grad.fold_scatter_cuda(feats, dd, steps, vol.shape, sign, params, vol=vol)
            return fused(), {"fused chain": fused}

        def route():
            d_vol, d_grad, folded = self.scatter_fn(feats, dd, steps, vol.shape, sign, params, True)
            return d_vol, d_grad, self.feats_grad_fn(feats, vol, folded, sign, params)

        folded = self.scatter_fn(feats, dd, steps, vol.shape, sign, params, True)[2]
        return route(), {
            "route": route,
            "zero-fill": lambda: torch.zeros(folded.shape, device=feats.device),
            "fold with the rows": lambda: self.scatter_fn(feats, dd, steps, vol.shape, sign, params, True),
            "B5": lambda: self.feats_grad_fn(feats, vol, folded, sign, params),
        }


def main(argv=None) -> int:
    import argparse

    import numpy as np
    import torch

    ap = argparse.ArgumentParser(description="Drive volym_tpu_torch once on one NVIDIA GPU and check it.")
    ap.add_argument("--parent", metavar="DIR", action="append", default=[],
                    help="a checkout of another commit: its march, replay and gate kernels are timed beside these "
                         "(may be given more than once)")
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; this check needs an NVIDIA GPU")
    from volym_tpu_torch import BENCHMARK_PARAMS, Camera, RenderParams, Scene, cli, convert, parity
    from volym_tpu_torch.ops import _build, feats_grad, lookahead, slab_march, slab_replay, voxel_grad
    from volym_tpu_torch.render import slab
    from volym_tpu_torch.render.renderer import make_renderer

    # phase 1: the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # phase 2: build, one nvcc per source, all at once
    if "arch=compute_90a,code=sm_90a" not in _build.NVCC_FLAGS:
        raise AssertionError("the kernels must be built for sm_90a")
    parents = [Before(d) for d in args.parent]
    with ThreadPoolExecutor(len(SOURCES) + sum(len(parent.names) for parent in parents)) as pool:
        own = pool.map(_build.build, SOURCES)
        theirs = [pool.map(parent.build, parent.names) for parent in parents]
        builds = dict(zip(SOURCES, own))
        before_builds = [dict(zip(parent.names, t)) for parent, t in zip(parents, theirs)]
    for name, built in builds.items():
        regs = [int(m) for m in re.findall(r"Used (\d+) registers", built.log)]
        spills = sum(int(m) for m in re.findall(r"(\d+) bytes spill", built.log))
        log(f"build: {built.path.name} for sm_90a in {built.seconds:.1f} s; ptxas: {len(regs)} kernels, "
            f"{min(regs, default=0)}-{max(regs, default=0)} registers, {spills} bytes of spill stores and loads")
    for name in Before.NAMES:
        log(f"ptxas {name}: {json.dumps(ptxas_report(builds[name].log))}")
    blocks, threads = lookahead.cone_occupancy()
    per_sm = torch.cuda.get_device_properties(0).max_threads_per_multi_processor
    cone_occupancy = dict(blocks_per_sm=blocks, threads_per_block=threads, occupancy=blocks * threads / per_sm)
    log(f"B7 occupancy (cudaOccupancyMaxActiveBlocksPerMultiprocessor): {json.dumps(cone_occupancy)}")
    for parent, built_by_name in zip(parents, before_builds):
        parent.load(built_by_name)
        for name, built in built_by_name.items():
            log(f"build --parent {parent.label} {name} in {built.seconds:.1f} s; "
                f"ptxas: {json.dumps(ptxas_report(built.log))}")

    def parent_ms(name, fn, reps, **kwargs):
        """The kernel ``name``'s ms in each ``--parent`` checkout on the
        same inputs (a list in their order), or None without one."""
        return [parent.ms(name, fn, reps, **kwargs) for parent in parents] if parents else None

    b2 = {}  # B2's ms per route and cell: this checkout's and each --parent's

    def time_replay(cell, fn, smooth=False):
        """B2's ms over 10 calls of ``fn`` (the wrapper's allocations
        included), kept in ``b2[cell]`` beside each ``--parent``'s and, under
        smoothing, each ``--parent``'s kernel with ``dd`` by ``torch.empty``
        (no zero-fill)."""
        row = dict(ms=cuda_ms(fn, 10), before=parent_ms("slab_replay", fn, 10))
        if smooth and parents:
            row["before_empty"] = parent_ms("slab_replay", fn, 10, alloc_dd=torch.empty)
        b2[cell] = row
        return row["ms"]

    # phase 3: kernels vs plain versions, small
    err = dict.fromkeys(KERNELS, 0.0)  # the largest absolute error
    rel = dict.fromkeys(KERNELS, 0.0)  # the largest error over the scale it is held to

    def hold(kernel, want, got, name, lut=None):
        """Hold ``got`` to ``want`` by the repo's rule (a LUT gradient, given
        its ``lut``, in two groups: ``parity.check_lut_grad``) and keep the
        kernel's largest errors.  -> (agreement, the worst opaque-end error
        over its magnitude)."""
        if lut is None:
            r, worst = parity.check_close(want, got, name), 0.0
        else:
            r, worst = parity.check_lut_grad(want, got, lut, name)
        err[kernel] = max(err[kernel], float((want - got).detach().abs().max()))
        rel[kernel] = max(rel[kernel], r.max_abs_err / r.scale, worst)
        return r, worst

    def hold_chain(feats, dd, steps, vol, sign, p, label):
        """The fused fold with the plain rows' camera chain (B5) on the
        replay's cotangents ``dd`` and step range ``steps``, against the
        plain composition: with one chunk of rows (``chunk`` = N) its
        d_feats must equal ``slab.feats_grad`` on the fold's own folded rows
        bit for bit; with one chunk and with the default chunks it is held
        to ``slab.feats_grad`` on the plain transpose's rows by the repo's
        rule, and its d_vol (d_grad) to the fold's without the chain.  ->
        (d_feats with one chunk, whether it equals the plain chain on the
        plain transpose's rows bit for bit)."""
        kernel = "voxel_grad_shaded" if dd.dim() == 4 else "voxel_grad"
        n = vol.shape[0]
        d_vol, d_grad, rows = voxel_grad.fold_scatter_cuda(feats, dd, steps, vol.shape, sign, p, True, n)
        # the plain transpose reads all of dd: 0.0 outside each ray's step range
        plain_rows = slab.smooth_voxel_grad(feats, slab.dense_dd(dd, steps), steps, vol.shape, sign, p, True)[2]
        plain = slab.feats_grad(feats, vol, plain_rows, sign, p)
        own = slab.feats_grad(feats, vol, rows, sign, p)
        if float(plain.abs().max()) <= 0.0:
            raise AssertionError(f"{label}: zero plain rows' chain")
        got = {}
        for chunk in (n, None):
            got[chunk] = voxel_grad.fold_scatter_cuda(feats, dd, steps, vol.shape, sign, p, chunk=chunk, vol=vol)
            torch.cuda.synchronize()
            hold(kernel, d_vol, got[chunk][0], f"{label} chain chunk={chunk} d_vol")
            if d_grad is not None:
                hold(kernel, d_grad, got[chunk][1], f"{label} chain chunk={chunk} d_grad")
            hold("feats_grad", plain, got[chunk][2], f"{label} B5 fused, chunk={chunk}")
        if not torch.equal(own, got[n][2]):
            raise AssertionError(f"{label}: the fused chain with one chunk differs from the plain chain on the "
                                 f"fold's rows by {float((own - got[n][2]).abs().max()):.3e}")
        return got[n][2], torch.equal(plain, got[n][2])

    worst_edge, n_march, n_emit, n_replay = 0.0, 0, 0, 0
    small_routes = {"march": [0, 0], "gated": [0, 0], "smoothing": [0, 0]}  # B1's (staged, direct) pairs

    def count_routes(key, feats, vol, grad, u8, p):
        pairs = staged_pairs(feats, vol, grad, u8, p)
        small_routes[key][0] += pairs["staged"]
        small_routes[key][1] += pairs["direct"]
    small = Scene.synthetic("bonsai", side=SMALL_SIDE, seed=0, device=dev)
    g_small = torch.from_numpy(
        np.random.default_rng(3).uniform(-1, 1, (SMALL_H, SMALL_W, 4)).astype(np.float32)
    ).to(dev)
    for h, v in ORBITS:
        cam = Camera(aspect=SMALL_W / SMALL_H, distance=1.3).orbit(h, v, 0.0).matrices()
        view = slab.dominant_axis(cam)
        for interp in ("nearest", "trilinear"):
            for stream, step in (("u8", 1.0 / SMALL_SIDE), ("f32", 2.0 / SMALL_SIDE)):
                for shading in (False, True):
                    label = f"view {view} {interp} {stream} shading={shading}"
                    p = RenderParams(
                        use_gaussian_smoothing=False, interpolation=interp, raymarching_step_size=step,
                        use_shading=shading, u8_volume=True, density_threshold=0.12, camera_grads=False,
                    )
                    feats, vol, lut, sign, grad, u8 = slab_march.prepare(small, cam, p, SMALL_H, SMALL_W)
                    if u8 != (stream == "u8"):
                        raise AssertionError(f"expected the {stream} stream")
                    got = slab_march.march_cuda(feats, vol, lut, sign, p, grad, u8=u8)
                    want = slab.march_slabs(feats, vol, lut, sign, p, grad, u8=u8)
                    torch.cuda.synchronize()
                    count_routes("march", feats, vol, grad, u8, p)
                    r, _ = hold("slab_march", want, got, label)
                    if not bool(torch.isfinite(got).all()):
                        raise AssertionError("non-finite kernel output")
                    worst_edge, n_march = max(worst_edge, r.edge_frac), n_march + 1

                    # B1 with the residual: image and residual bit for bit
                    img, dens = slab_march.march_cuda(feats, vol, lut, sign, p, grad, u8=u8, emit_density=True)
                    plain_img, plain_dens = slab.march_slabs(feats, vol, lut, sign, p, grad, u8, emit_density=True)
                    torch.cuda.synchronize()
                    if not torch.equal(img, got) or not torch.equal(plain_img, want):
                        raise AssertionError(f"{label}: the residual changed the image")
                    if not torch.equal(dens, plain_dens):
                        raise AssertionError(f"{label}: residual differs from the plain march")
                    n_emit += 1

                    # B2 from the residual and re-sampled, against the plain replay
                    plain = slab.replay_slabs(feats, vol, lut, sign, p, img, g_small, grad, u8, dens)
                    routes = {}
                    for route, d in (("stored", dens), ("re-sampled", None)):
                        routes[route] = slab_replay.replay_cuda(feats, vol, lut, sign, p, img, g_small, grad, u8, d)
                        torch.cuda.synchronize()
                        for name, a, b in zip(("d_vol", "d_grad", "d_lut"), plain, routes[route]):
                            if a is None:
                                continue
                            if not bool(torch.isfinite(b).all()):
                                raise AssertionError(f"{label} {route} {name}: non-finite")
                            hold("slab_replay", a, b, f"{label} {route} {name}", lut if name == "d_lut" else None)
                        n_replay += 1
                    for name, a, b in zip(("d_vol", "d_grad", "d_lut"), routes["stored"], routes["re-sampled"]):
                        if a is None:
                            continue
                        if name == "d_lut":
                            parity.check_lut_grad(a, b, lut, f"{label} stored vs re-sampled {name}")
                        else:
                            parity.check_close(a, b, f"{label} stored vs re-sampled {name}")
    log(f"small: march == plain in {n_march}/48 cases (max abs err {err['slab_march']:.3e}, "
        f"worst knife-edge share {worst_edge:.2e})")
    log(f"small: march with residual == plain bit for bit in {n_emit}/48 cases; B1's (block, batch) pairs "
        f"staged / direct {small_routes['march']}")
    log(f"small: replay == plain in {n_replay}/96 cases, stored and re-sampled "
        f"(max abs err {err['slab_replay']:.3e}, max err over its scale {rel['slab_replay']:.3e}); "
        f"the two routes agree in all {n_emit}")
    if (n_march, n_emit, n_replay) != (48, 48, 96):
        raise AssertionError(f"{n_march}, {n_emit}, {n_replay} small cases ran, expected 48, 48, 96")

    # B6 and B7 against the plain gate, and B1 with the gate against the
    # plain march with it, bit for bit, on the three-level scene
    small3 = convert.scene(*three_level_scene(SMALL_SIDE), device=dev)
    n_gate, n_gated, n_changed, n_gated_smooth = 0, 0, 0, 0
    for h, v in ORBITS:
        cam = Camera(aspect=SMALL_W / SMALL_H, distance=1.3).orbit(h, v, 0.0).matrices()
        view = slab.dominant_axis(cam)
        for stream, step, interp, shading in (("u8", 1.0 / SMALL_SIDE, "trilinear", False),
                                              ("f32", 2.0 / SMALL_SIDE, "nearest", True)):
            for cone in (False, True):
                kernel = "lookahead_cone" if cone else "lookahead_straight"
                label = f"view {view} {stream} {interp} shading={shading} cone={cone}"
                p = RenderParams(
                    use_gaussian_smoothing=False, interpolation=interp, raymarching_step_size=step,
                    use_shading=shading, u8_volume=True, density_threshold=0.12,
                    use_importance_rendering=True, use_cone_importance_check=cone,
                )
                feats, vol, lut, sign, grad, u8 = slab_march.prepare(small3, cam, p, SMALL_H, SMALL_W)
                if u8 != (stream == "u8"):
                    raise AssertionError(f"expected the {stream} stream")
                cone_feats, levels = slab_march.lookahead_inputs(small3, cam, p, SMALL_H, SMALL_W)
                words = lookahead.gate_cuda(feats, cone_feats, levels, sign, p.subtexel_bits)
                want = slab.lookahead_gate(feats, cone_feats, levels, sign, p.subtexel_bits)
                torch.cuda.synchronize()
                got = lookahead.unpack_gate(words, vol.shape[0])
                parity.check_gate(want, got, label)
                err[kernel] = max(err[kernel], float((want.float() - got.float()).abs().max()))
                if not bool(want.any()):
                    raise AssertionError(f"{label}: the gate never engages")
                n_gate += 1

                img = slab_march.march_cuda(feats, vol, lut, sign, p, grad, u8=u8, gate=words)
                plain = slab.march_slabs(feats, vol, lut, sign, p, grad, u8, gate=want)
                torch.cuda.synchronize()
                count_routes("gated", feats, vol, grad, u8, p)
                if not torch.equal(img, plain):
                    raise AssertionError(f"{label}: the march with the gate differs from the plain one by "
                                         f"{float((img - plain).abs().max()):.3e}")
                n_gated += 1
                n_changed += not torch.equal(plain, slab.march_slabs(feats, vol, lut, sign, p, grad, u8))

                # the gate with Gaussian smoothing (same planes, same gate)
                ps = p.replace(use_gaussian_smoothing=True)
                img = slab_march.march_cuda(feats, vol, lut, sign, ps, grad, u8=u8, gate=words)
                plain_s = slab.march_slabs(feats, vol, lut, sign, ps, grad, u8, gate=want)
                torch.cuda.synchronize()
                if not torch.equal(img, plain_s):
                    raise AssertionError(f"{label}: the smoothed march with the gate differs from the plain one by "
                                         f"{float((img - plain_s).abs().max()):.3e}")
                n_gated_smooth += 1
    log(f"small: gate kernels == plain gate bit for bit in {n_gate}/24 cases; march with the gate == plain "
        f"bit for bit in {n_gated}/24, the gate changed the image in {n_changed}; with smoothing too in "
        f"{n_gated_smooth}/24; B1's (block, batch) pairs staged / direct {small_routes['gated']}")
    if (n_gate, n_gated, n_gated_smooth) != (24, 24, 24) or not n_changed:
        raise AssertionError(f"{n_gate}, {n_gated}, {n_gated_smooth} gate cases ran, expected 24, 24, 24; "
                             f"{n_changed} changed the image")

    # Gaussian smoothing: B1 (bit for bit), B2 unfused on both routes and
    # B3/B4 against their plain versions, on the 256^3 bonsai
    t0 = time.perf_counter()
    scene = Scene.synthetic("bonsai", side=FULL_SIDE, seed=0, device=dev)
    log(f"scene: {FULL_SIDE}^3 synthetic bonsai made in {time.perf_counter() - t0:.1f} s")
    n_smooth, n_smooth_replay, n_scatter, n_engaged, n_fold, n_dd_bits = 0, 0, 0, 0, 0, 0
    fold_rows = [0, 0]  # folded rows with one source an offset: bit-equal, compared
    for h, v in ORBITS:
        cam = Camera(aspect=SMALL_W / SMALL_H, distance=1.3).orbit(h, v, 0.0).matrices()
        view = slab.dominant_axis(cam)
        for interp in ("nearest", "trilinear"):
            for stream, step, planes in (("u8", 0.005, FULL_SIDE), ("f32", 0.01, FULL_SIDE // 2)):
                for shading in (False, True):
                    label = f"smoothing view {view} {interp} {stream} shading={shading}"
                    p = RenderParams(
                        use_gaussian_smoothing=True, interpolation=interp, raymarching_step_size=step,
                        use_shading=shading, u8_volume=True, density_threshold=0.12, camera_grads=False,
                    )
                    feats, vol, lut, sign, grad, u8 = slab_march.prepare(scene, cam, p, SMALL_H, SMALL_W)
                    if u8 != (stream == "u8") or vol.shape[0] != planes:
                        raise AssertionError(f"{label}: expected the {stream} stream on {planes} planes")
                    img = slab_march.march_cuda(feats, vol, lut, sign, p, grad, u8=u8)
                    img_e, dens = slab_march.march_cuda(feats, vol, lut, sign, p, grad, u8=u8, emit_density=True)
                    plain_img, plain_dens = slab.march_slabs(feats, vol, lut, sign, p, grad, u8, emit_density=True)
                    torch.cuda.synchronize()
                    if not (torch.equal(img, plain_img) and torch.equal(img_e, img)):
                        raise AssertionError(f"{label}: the image differs from the plain march by "
                                             f"{float((img - plain_img).abs().max()):.3e}")
                    if not torch.equal(dens, plain_dens):
                        raise AssertionError(f"{label}: the residual differs from the plain march")
                    count_routes("smoothing", feats, vol, grad, u8, p)
                    n_smooth += 1
                    n_engaged += not torch.equal(
                        img, slab_march.march_cuda(feats, vol, lut, sign, p.replace(use_gaussian_smoothing=False),
                                                   grad, u8=u8))

                    plain_dd, plain_steps, plain_lut = slab.replay_slabs(feats, vol, lut, sign, p, img, g_small, grad,
                                                                         u8, dens)
                    if not torch.equal(slab.dense_dd(plain_dd, plain_steps), plain_dd):
                        raise AssertionError(f"{label}: the plain dd is not 0.0 outside its step range")
                    routes = {}
                    for route, d in (("stored", dens), ("re-sampled", None)):
                        dd, steps, d_lut = slab_replay.replay_cuda(feats, vol, lut, sign, p, img, g_small, grad, u8, d)
                        torch.cuda.synchronize()
                        if not torch.equal(plain_steps, steps):
                            raise AssertionError(f"{label} {route}: the step range differs from the plain replay's")
                        # the kernel writes dd only inside each ray's step range
                        dd = slab.dense_dd(dd, steps)
                        if not (bool(torch.isfinite(dd).all()) and bool(torch.isfinite(d_lut).all())):
                            raise AssertionError(f"{label} {route}: non-finite")
                        hold("slab_replay", plain_dd, dd, f"{label} {route} dd")
                        hold("slab_replay", plain_lut, d_lut, f"{label} {route} d_lut", lut)
                        routes[route] = dd
                        n_smooth_replay, n_dd_bits = n_smooth_replay + 1, n_dd_bits + torch.equal(plain_dd, dd)
                    if not torch.equal(routes["stored"], routes["re-sampled"]):
                        raise AssertionError(f"{label}: the two replay routes give different cotangents")

                    # B3/B4 without the fold, on the plain-folded cotangents
                    kernel = "voxel_grad_shaded" if shading else "voxel_grad"
                    folded = unfold(feats, plain_dd, vol.shape, p)
                    d_vol, d_grad = voxel_grad.scatter_cuda(feats, folded, vol.shape, sign, p)
                    plain_vol, plain_grad = slab.voxel_grad(feats, folded, vol.shape, sign, p)
                    torch.cuda.synchronize()
                    hold(kernel, plain_vol, d_vol, f"{label} d_vol")
                    if shading:
                        hold(kernel, plain_grad, d_grad, f"{label} d_grad")
                    if float(plain_vol.abs().max()) <= 0.0:
                        raise AssertionError(f"{label}: zero d_vol")
                    n_scatter += 1

                    # the fused fold-and-scatter, the folded rows asked for on 256 planes
                    want_rows = stream == "u8"
                    d_vol, d_grad, rows = voxel_grad.fold_scatter_cuda(feats, plain_dd, plain_steps, vol.shape, sign,
                                                                       p, want_rows)
                    fv, fg, frows = slab.smooth_voxel_grad(feats, plain_dd, plain_steps, vol.shape, sign, p, True)
                    torch.cuda.synchronize()
                    hold(kernel, fv, d_vol, f"{label} fold d_vol")
                    if shading:
                        hold(kernel, fg, d_grad, f"{label} fold d_grad")
                    if want_rows:
                        inner = frows[1:-1] == rows[1:-1]
                        fold_rows[0] += int(inner.reshape(inner.shape[0], -1).all(1).sum())
                        fold_rows[1] += inner.shape[0]
                        hold(kernel, frows, rows, f"{label} folded rows")
                    elif rows is not None:
                        raise AssertionError(f"{label}: folded rows not asked for, but returned")
                    n_fold += 1
    log(f"small smoothing: march with residual == plain bit for bit in {n_smooth}/48 cases (smoothing changed "
        f"the image in {n_engaged}); unfused replay == plain in {n_smooth_replay}/96, stored and re-sampled, the "
        f"two routes bit for bit, the step range bit for bit, dd on it bit for bit in {n_dd_bits}; B3/B4 without "
        f"the fold == plain in {n_scatter}/48 and "
        f"fused with the fold == plain in {n_fold}/48 (max abs err {err['voxel_grad']:.3e} / "
        f"{err['voxel_grad_shaded']:.3e}, over its scale {rel['voxel_grad']:.3e} / {rel['voxel_grad_shaded']:.3e}); "
        f"folded rows with one source an offset bit for bit: {fold_rows[0]}/{fold_rows[1]}; B1's (block, batch) "
        f"pairs staged / direct {small_routes['smoothing']}")
    if not (sum(r[0] for r in small_routes.values()) and sum(r[1] for r in small_routes.values())):
        raise AssertionError(f"the small cases should take both of B1's routes: {small_routes}")
    if (n_smooth, n_smooth_replay, n_scatter, n_fold) != (48, 96, 48, 48) or n_engaged != 48:
        raise AssertionError(f"{n_smooth}, {n_smooth_replay}, {n_scatter}, {n_fold} smoothing cases ran, expected 48, "
                             f"96, 48, 48; smoothing changed {n_engaged} images")

    # camera gradients: B2's camera mode and B5 (fused into the fold) against
    # their plain versions (f32: camera cotangents turn the u8 stream and the
    # residual off), the smoothed cases on the 256^3 bonsai
    n_cam, n_cam_bits, n_b5, n_b5_bits = 0, 0, 0, 0
    for h, v in ORBITS:
        cam = Camera(aspect=SMALL_W / SMALL_H, distance=1.3).orbit(h, v, 0.0).matrices()
        view = slab.dominant_axis(cam)
        for interp in ("nearest", "trilinear"):
            tri = interp == "trilinear"
            for shading in (False, True):
                for smooth in (False, True):
                    label = f"camera view {view} {interp} shading={shading} smoothing={smooth}"
                    step = (0.005 if tri else 0.01) if smooth else (1.0 if tri else 2.0) / SMALL_SIDE
                    p = RenderParams(use_gaussian_smoothing=smooth, interpolation=interp, use_shading=shading,
                                     raymarching_step_size=step, density_threshold=0.12)
                    feats, vol, lut, sign, grad, u8 = slab_march.prepare(scene if smooth else small, cam, p, SMALL_H,
                                                                         SMALL_W)
                    if u8:
                        raise AssertionError(f"{label}: expected the f32 stream")
                    img = slab_march.march_cuda(feats, vol, lut, sign, p, grad)
                    want = slab.replay_slabs(feats, vol, lut, sign, p, img, g_small, grad)
                    got = slab_replay.replay_cuda(feats, vol, lut, sign, p, img, g_small, grad)
                    torch.cuda.synchronize()
                    if smooth:  # the kernel writes dd only inside each ray's step range
                        got = (slab.dense_dd(got[0], got[1]), *got[1:])
                    if not all(bool(torch.isfinite(t).all()) for t in got if t is not None):
                        raise AssertionError(f"{label}: non-finite")
                    if float(want[-1].abs().max()) <= 0.0:
                        raise AssertionError(f"{label}: zero d_feats")
                    hold("slab_replay", want[0], got[0], f"{label} {'dd' if smooth else 'd_vol'}")
                    if smooth:
                        if not torch.equal(want[1], got[1]):
                            raise AssertionError(f"{label}: the step range differs from the plain replay's")
                    elif shading:
                        hold("slab_replay", want[1], got[1], f"{label} d_grad")
                    hold("slab_replay", want[-2], got[-2], f"{label} d_lut", lut)
                    hold("slab_replay", want[-1], got[-1], f"{label} d_feats")
                    n_cam, n_cam_bits = n_cam + 1, n_cam_bits + torch.equal(want[-1], got[-1])
                    if smooth and tri:
                        bits = hold_chain(feats, want[0], want[1], vol, sign, p, label)[1]
                        n_b5, n_b5_bits = n_b5 + 1, n_b5_bits + bits
    log(f"small camera: B2's camera chain == plain in {n_cam}/48 cases (d_feats bit for bit in {n_cam_bits}); "
        f"B5 fused into the fold == plain in {n_b5}/12 (with one chunk bit for bit with the plain chain on the "
        f"kernel's folded rows in all, on the plain transpose's in {n_b5_bits}; max abs err {err['feats_grad']:.3e}, "
        f"over its scale {rel['feats_grad']:.3e})")
    if (n_cam, n_b5) != (48, 12):
        raise AssertionError(f"{n_cam}, {n_b5} camera cases ran, expected 48, 12")

    # the last modes of B1 and B2 on the three-level scene's volume with
    # u8-representable uniform importance: every view x {u8 trilinear native,
    # f32 nearest resampled} x {shaded, unshaded} x {smoothing off, on}: B1's
    # coloring, first-hit (half the cases gated, straight or cone by view)
    # and the residual under the gate, bit for bit; B2 in coloring mode and
    # gated on the fused, unfused, stored and re-sampled routes within the
    # repo's rule; on the f32 cases B2's camera chain gated and in coloring
    # mode
    color3 = Scene(small3.volume, torch.from_numpy(
        np.round(np.random.default_rng(21).uniform(0.0, 1.0, (SMALL_SIDE,) * 3) * 255.0) / np.float32(255.0)
    ).float().to(dev), small3.tf_lut)
    modes = dict.fromkeys(("coloring", "coloring replay", "first-hit", "gated residual", "gated replay",
                           "gated camera", "coloring camera"), 0)
    n_first_changed = 0
    small_routes["modes"] = [0, 0]
    for i_view, (h, v) in enumerate(ORBITS):
        cam = Camera(aspect=SMALL_W / SMALL_H, distance=1.3).orbit(h, v, 0.0).matrices()
        view = slab.dominant_axis(cam)
        cone = i_view % 2 == 1
        for stream, step, interp in (("u8", 1.0 / SMALL_SIDE, "trilinear"), ("f32", 2.0 / SMALL_SIDE, "nearest")):
            for shading in (False, True):
                for smooth in (False, True):
                    label = f"view {view} {stream} {interp} shading={shading} smoothing={smooth}"
                    base = RenderParams(
                        use_gaussian_smoothing=smooth, interpolation=interp, raymarching_step_size=step,
                        use_shading=shading, u8_volume=True, density_threshold=0.12, camera_grads=False,
                    )
                    pc = base.replace(use_importance_coloring=True)
                    feats, vol, lut, sign, grad, u8 = slab_march.prepare(color3, cam, pc, SMALL_H, SMALL_W)
                    if u8 != (stream == "u8"):
                        raise AssertionError(f"{label}: expected the {stream} stream")
                    imp = slab_march.importance_perm(color3.importance, view[0], vol.shape[0]).contiguous()
                    img = slab_march.march_cuda(feats, vol, lut, sign, pc, grad, u8=u8, imp_perm=imp)
                    want = slab.march_slabs(feats, vol, lut, sign, pc, grad, u8, imp_perm=imp)
                    torch.cuda.synchronize()
                    count_routes("modes", feats, vol, grad, u8, pc)
                    if not torch.equal(img, want):
                        raise AssertionError(f"{label}: coloring differs from the plain march by "
                                             f"{float((img - want).abs().max()):.3e}")
                    modes["coloring"] += 1
                    plain = slab.replay_slabs(feats, vol, lut, sign, pc, img, g_small, grad, u8, imp_perm=imp)
                    got = slab_replay.replay_cuda(feats, vol, lut, sign, pc, img, g_small, grad, u8, imp_perm=imp)
                    torch.cuda.synchronize()
                    if float(plain[0].abs().max()) <= 0.0 or bool(got[2].any()):
                        raise AssertionError(f"{label}: no d_imp, or a LUT gradient under coloring")
                    hold("slab_replay", plain[0], got[0], f"{label} coloring d_imp")
                    if shading:
                        hold("slab_replay", plain[1], got[1], f"{label} coloring d_grad")
                    modes["coloring replay"] += 1
                    if stream == "f32":
                        pcc = pc.replace(camera_grads=True)
                        plain = slab.replay_slabs(feats, vol, lut, sign, pcc, img, g_small, grad, imp_perm=imp)
                        got = slab_replay.replay_cuda(feats, vol, lut, sign, pcc, img, g_small, grad, imp_perm=imp)
                        torch.cuda.synchronize()
                        hold("slab_replay", plain[0], got[0], f"{label} coloring camera d_imp")
                        hold("slab_replay", plain[-1], got[-1], f"{label} coloring camera d_feats")
                        modes["coloring camera"] += 1

                    # first-hit, gated in half the cases
                    gated = shading == smooth
                    pf = base.replace(use_opacity=False, use_importance_rendering=gated,
                                      use_cone_importance_check=gated and cone)
                    words = plane = None
                    if gated:
                        cone_feats, levels = slab_march.lookahead_inputs(color3, cam, pf, SMALL_H, SMALL_W)
                        words = lookahead.gate_cuda(feats, cone_feats, levels, sign, pf.subtexel_bits)
                        plane = lookahead.unpack_gate(words, vol.shape[0])
                    img = slab_march.march_cuda(feats, vol, lut, sign, pf, grad, u8=u8, gate=words)
                    want = slab.march_slabs(feats, vol, lut, sign, pf, grad, u8, gate=plane)
                    torch.cuda.synchronize()
                    if not torch.equal(img, want):
                        raise AssertionError(f"{label}: first-hit differs from the plain march by "
                                             f"{float((img - want).abs().max()):.3e}")
                    modes["first-hit"] += 1
                    n_first_changed += not torch.equal(img, slab.march_slabs(
                        feats, vol, lut, sign, pf.replace(use_opacity=True), grad, u8, gate=plane))

                    # the residual under the gate, and B2 gated on both routes
                    pg = base.replace(use_importance_rendering=True, use_cone_importance_check=cone)
                    cone_feats, levels = slab_march.lookahead_inputs(color3, cam, pg, SMALL_H, SMALL_W)
                    words = lookahead.gate_cuda(feats, cone_feats, levels, sign, pg.subtexel_bits)
                    plane = lookahead.unpack_gate(words, vol.shape[0])
                    img, dens = slab_march.march_cuda(feats, vol, lut, sign, pg, grad, u8=u8, gate=words,
                                                      emit_density=True)
                    plain_img, plain_dens = slab.march_slabs(feats, vol, lut, sign, pg, grad, u8, emit_density=True,
                                                             gate=plane)
                    torch.cuda.synchronize()
                    if not (torch.equal(img, plain_img) and torch.equal(dens, plain_dens)):
                        raise AssertionError(f"{label}: the gated march with its residual differs from the plain one")
                    modes["gated residual"] += 1
                    plain = slab.replay_slabs(feats, vol, lut, sign, pg, img, g_small, grad, u8, dens, plane)
                    for route, d in (("stored", dens), ("re-sampled", None)):
                        got = slab_replay.replay_cuda(feats, vol, lut, sign, pg, img, g_small, grad, u8, d, words)
                        torch.cuda.synchronize()
                        if smooth:
                            if not torch.equal(plain[1], got[1]):
                                raise AssertionError(f"{label} gated {route}: the step range differs")
                            got = (slab.dense_dd(got[0], got[1]), *got[1:])
                        hold("slab_replay", plain[0], got[0], f"{label} gated {route} {'dd' if smooth else 'd_vol'}")
                        if shading and not smooth:
                            hold("slab_replay", plain[1], got[1], f"{label} gated {route} d_grad")
                        hold("slab_replay", plain[2], got[2], f"{label} gated {route} d_lut", lut)
                        modes["gated replay"] += 1
                    if stream == "f32":
                        pgc = pg.replace(camera_grads=True)
                        plain = slab.replay_slabs(feats, vol, lut, sign, pgc, img, g_small, grad, gate=plane)
                        got = slab_replay.replay_cuda(feats, vol, lut, sign, pgc, img, g_small, grad, gate=words)
                        torch.cuda.synchronize()
                        if smooth:
                            got = (slab.dense_dd(got[0], got[1]), *got[1:])
                        hold("slab_replay", plain[0], got[0], f"{label} gated camera {'dd' if smooth else 'd_vol'}")
                        hold("slab_replay", plain[-1], got[-1], f"{label} gated camera d_feats")
                        modes["gated camera"] += 1
    log(f"small new modes: {json.dumps(modes)} cases; B1 bit for bit in coloring, first-hit (which changed the image "
        f"in {n_first_changed}) and the gated residual; B2 within the rule (max abs err {err['slab_replay']:.3e}, "
        f"over its scale {rel['slab_replay']:.3e}); B1's (block, batch) pairs staged / direct {small_routes['modes']}")
    want_modes = {"coloring": 48, "coloring replay": 48, "first-hit": 48, "gated residual": 48, "gated replay": 96,
                  "gated camera": 24, "coloring camera": 24}
    if modes != want_modes or n_first_changed < 24:
        raise AssertionError(f"new-mode cases {modes}, expected {want_modes}; first-hit changed {n_first_changed}")

    # phase 4: serving at full size
    configs = {
        "bench": bench_forward(),
        "cli_default": RenderParams(
            interpolation="nearest", density_threshold=0.12, raymarching_step_size=0.01,
            use_shading=True, use_gaussian_smoothing=False, u8_volume=True,
        ),
    }
    configs["bench_gaussian"] = configs["bench"].replace(use_gaussian_smoothing=True)
    # the flags of `screenshot` with no options: smoothing on
    configs["cli_default_gaussian"] = cli._params(cli.build_parser().parse_args(["screenshot"]))
    if configs["cli_default_gaussian"] != configs["cli_default"].replace(use_gaussian_smoothing=True):
        raise AssertionError(f"the CLI default is {configs['cli_default_gaussian']}")
    renderers = {
        name: make_renderer(scene, p, FULL_H, FULL_W, backend="slab_cuda", device=dev) for name, p in configs.items()
    }
    cams = {}
    frames = {}
    per_config = {}
    slab_march.LAUNCHES = slab_replay.LAUNCHES = 0  # the serving path starts here
    zero_tables()
    for name, render in renderers.items():
        before = slab_march.LAUNCHES
        cam = Camera(aspect=FULL_W / FULL_H)
        cams[name] = []
        for i in range(FRAMES):
            cam = cam.orbit(2.0, 0.0, 0.0)
            img = render(cam.matrices())
            if i == 0:
                frames[name] = img
            cams[name].append(cam)
        torch.cuda.synchronize()
        per_config[name] = slab_march.LAUNCHES - before
    serving_launches = slab_march.LAUNCHES  # the serving path ends here
    serving_tables = read_tables("serving", serving_launches, 0)
    if slab_replay.LAUNCHES:
        raise AssertionError("the serving path launched the replay")
    for name, n in per_config.items():
        if n != FRAMES:
            raise AssertionError(f"{name}: {n} kernel launches for {FRAMES} frames")
    log(f"serving: {serving_launches} march launches for {len(configs) * FRAMES} frames ({per_config})")

    results = {}
    for name, p in configs.items():
        img = frames[name]
        if tuple(img.shape) != (FULL_H, FULL_W, 4) or not bool(torch.isfinite(img).all()):
            raise AssertionError(f"{name}: bad frame {tuple(img.shape)}")
        hit = img[..., 3] > 0.5
        if float(hit.float().mean()) < 0.05 or float(img[..., :3].max()) <= 0.0:
            raise AssertionError(f"{name}: the frame is empty")
        cm0 = cams[name][0].matrices()
        plain = slab_march.render(scene, cm0, p, FULL_H, FULL_W, march_fn=slab.march_slabs)
        r, _ = hold("slab_march", plain, img, f"{name} frame 0 vs plain")
        if p.use_gaussian_smoothing and not torch.equal(plain, img):
            raise AssertionError(f"{name}: frame 0 differs from the plain version by {r.max_abs_err:.3e}")
        del plain

        feats, vol, lut, sign, grad, u8 = slab_march.prepare(scene, cm0, p, FULL_H, FULL_W)
        march_ms = cuda_ms(lambda: slab_march.march_cuda(feats, vol, lut, sign, p, grad, u8=u8), 20)
        march_before_ms = parent_ms(
            "slab_march", lambda: slab_march.march_cuda(feats, vol, lut, sign, p, grad, u8=u8), 20)
        plain_march_ms = cuda_ms(lambda: slab.march_slabs(feats, vol, lut, sign, p, grad, u8=u8), 3)
        frame_ms = cuda_ms(lambda: renderers[name](cm0), 10)
        plain_frame_ms = cuda_ms(lambda: slab_march.render(scene, cm0, p, FULL_H, FULL_W, march_fn=slab.march_slabs), 3)
        rays = FULL_H * FULL_W
        # composited steps of this frame and, for the stencil, the sampled
        # ones and those of them whose stencil runs, for the operations bound
        _, dens = slab.march_slabs(feats, vol, lut, sign, p, grad, u8, emit_density=True)
        threshold = slab.march_knobs(p, u8)[0]
        d0 = dens.reshape(vol.shape[0], -1, rays)[:, 0]
        composited, sampled = int((d0 >= threshold).sum()), int((d0 != 0.0).sum())
        stencils = stencil_steps(feats, vol, sign, p, threshold, d0 != 0.0) if p.use_gaussian_smoothing else 0
        del dens, d0
        ops = composited * MARCH_OPS_PER_STEP + stencils * SMOOTH_OPS_PER_STEP
        bound_ms, bound_by = bound(nbytes(feats, vol, lut, grad) + rays * 16, ops)
        results[name] = dict(
            planes=int(vol.shape[0]), u8=u8, smoothing=p.use_gaussian_smoothing, march_ms=march_ms,
            march_before_ms=march_before_ms, stage=staged_pairs(feats, vol, grad, u8, p),
            plain_march_ms=plain_march_ms, bound_ms=bound_ms, bound_by=bound_by, composited_steps=composited,
            sampled_steps=sampled, stencil_steps=stencils,
            frame_ms=frame_ms, plain_frame_ms=plain_frame_ms,
            rays_per_s=rays / (frame_ms / 1e3), plain_rays_per_s=rays / (plain_frame_ms / 1e3),
            max_abs_err=r.max_abs_err, knife_edge_share=r.edge_frac, hit_share=float(hit.float().mean()),
        )
        log(f"{name}: {json.dumps(results[name])}")

    # phase 4b: the per-ray and cone tables' kernels against the chain at
    # full size, bit for bit, and their times
    tables = table_path(dev)

    # phase 5: serving with importance look-ahead at full size
    t0 = time.perf_counter()
    teapot = Scene.synthetic("teapot", side=FULL_SIDE, device=dev)
    log(f"scene: {FULL_SIDE}^3 synthetic teapot with its lobster importance made in {time.perf_counter() - t0:.1f} s")
    sweep = BENCHMARK_PARAMS.replace(raymarching_step_size=0.005, u8_volume=True)
    la_configs = {
        "base": sweep,
        "importance": sweep.replace(use_importance_rendering=True),
        "importance_cone": sweep.replace(use_importance_rendering=True, use_cone_importance_check=True),
        "importance_cone_step01": sweep.replace(
            use_importance_rendering=True, use_cone_importance_check=True, raymarching_step_size=0.01
        ),
    }
    la_renderers = {
        name: make_renderer(teapot, p, FULL_H, FULL_W, backend="slab_cuda", device=dev) for name, p in la_configs.items()
    }

    la_cams, la_frames, la_counts = {}, {}, {}
    # the look-ahead serving path starts here
    slab_march.LAUNCHES = slab_replay.LAUNCHES = lookahead.STRAIGHT_LAUNCHES = lookahead.CONE_LAUNCHES = 0
    zero_tables()
    for name, render in la_renderers.items():
        before = launch_counts()
        cam = Camera(aspect=FULL_W / FULL_H)
        for i in range(FRAMES):
            cam = cam.orbit(2.0, 0.0, 0.0)
            img = render(cam.matrices())
            if i == 0:
                la_cams[name], la_frames[name] = cam, img
        torch.cuda.synchronize()
        la_counts[name] = tuple(a - b for a, b in zip(launch_counts(), before))
    la_launches = launch_counts()  # the look-ahead serving path ends here
    la_tables = read_tables("look-ahead serving", la_launches[0], la_launches[2])
    if slab_replay.LAUNCHES:
        raise AssertionError("the look-ahead serving path launched the replay")
    want_counts = {"base": (FRAMES, 0, 0), "importance": (FRAMES, FRAMES, 0),
                   "importance_cone": (FRAMES, 0, FRAMES), "importance_cone_step01": (FRAMES, 0, FRAMES)}
    if la_counts != want_counts:
        raise AssertionError(f"look-ahead serving: (march, straight, cone) launches {la_counts}, expected {want_counts}")
    log(f"look-ahead serving: {la_launches[0]} march, {la_launches[1]} straight and {la_launches[2]} cone gate "
        f"launches for {len(la_configs) * FRAMES} frames ({la_counts})")

    def time_gate(label, scene, cm, p, feats, sign):
        """B6 or B7 on one frame's inputs, held bit for bit to the plain
        gate and timed beside each ``--parent``'s and the plain gate, with
        its bound (B6: on the count of the range tests and taps it must
        run, and on the count before its skips) -> (row, packed gate)."""
        kernel = "lookahead_cone" if p.use_cone_importance_check else "lookahead_straight"
        cone_feats, levels = slab_march.lookahead_inputs(scene, cm, p, FULL_H, FULL_W)
        gate_args = (feats, cone_feats, levels, sign, p.subtexel_bits)
        words = lookahead.gate_cuda(*gate_args)
        plain_gate = slab.lookahead_gate(*gate_args)
        torch.cuda.synchronize()
        got = lookahead.unpack_gate(words, levels.shape[0])
        parity.check_gate(plain_gate, got, f"{label} gate")
        err[kernel] = max(err[kernel], float((plain_gate.float() - got.float()).abs().max()))
        if not bool(plain_gate.any()):
            raise AssertionError(f"{label}: the gate never engages")
        n_bytes = gate_bytes(feats, cone_feats, levels, words)
        row = dict(kernel=kernel, gate_ms=cuda_ms(lambda: lookahead.gate_cuda(*gate_args), 20),
                   gate_before_ms=parent_ms("lookahead", lambda: lookahead.gate_cuda(*gate_args), 20),
                   plain_gate_ms=cuda_ms(lambda: slab.lookahead_gate(*gate_args), 2))
        if kernel == "lookahead_cone":
            gate_bound = bound(n_bytes, gate_ops(*gate_args[:3], plain_gate))
        else:
            # the transcription's gate is the plain one, and its counts what the kernel does
            transcribed, work = straight_gate(feats, levels, sign, p.subtexel_bits)
            parity.check_gate(plain_gate, transcribed, f"{label} transcribed gate")
            del transcribed
            gate_bound = bound(n_bytes, gate_ops(feats, None, levels, plain_gate, work))
            valid = max(work["valid"], 1)
            row.update(gate_bound_old_count=list(bound(n_bytes, gate_ops(feats, None, levels, plain_gate))),
                       work=work, range_test_share=work["range_tests"] / valid, tap_share=work["taps"] / valid,
                       span_tap_share=work["span_taps"] / valid, visited_share=work["visited"] / valid,
                       set_bit_share_of_valid=float(plain_gate.sum()) / valid)
            log(f"B6 work, {label}: of {work['valid']} valid steps, range tests ran at "
                f"{row['range_test_share']:.4f}, taps were taken at {row['tap_share']:.4f} (within the span "
                f"{row['span_tap_share']:.4f}), bits set at {row['set_bit_share_of_valid']:.4f}; steps visited "
                f"{work['visited']}; bound {gate_bound[0]:.4f} ms ({gate_bound[1]}), "
                f"{row['gate_bound_old_count'][0]:.4f} ms ({row['gate_bound_old_count'][1]}) on the count before "
                f"the skips")
        row.update(
            planes=int(levels.shape[0]), gate_bound_ms=gate_bound[0], gate_bound_by=gate_bound[1],
            gate_mib=words.numel() * 4 / 2**20, set_bit_share=float(plain_gate.float().mean()),
            # what the bounds pass lets the kernels skip: the slices with
            # important texels, and the share of their area the rows and
            # columns of those texels span
            **important_span(levels),
        )
        del plain_gate, got
        return row, words

    la_results = {}
    for name, p in la_configs.items():
        img, cm0 = la_frames[name], la_cams[name].matrices()
        if tuple(img.shape) != (FULL_H, FULL_W, 4) or not bool(torch.isfinite(img).all()):
            raise AssertionError(f"{name}: bad frame {tuple(img.shape)}")
        if float((img[..., 3] > 0.5).float().mean()) < 0.05:
            raise AssertionError(f"{name}: the frame is empty")

        def plain_frame(p=p, cm0=cm0):
            return slab_march.render(teapot, cm0, p, FULL_H, FULL_W, march_fn=slab.march_slabs,
                                     gate_fn=slab.lookahead_gate)

        r, _ = hold("slab_march", plain_frame(), img, f"{name} frame 0 vs plain")
        feats, vol, lut, sign, grad, u8 = slab_march.prepare(teapot, cm0, p, FULL_H, FULL_W)
        row = dict(planes=int(vol.shape[0]), u8=u8, max_abs_err=r.max_abs_err, knife_edge_share=r.edge_frac)
        words = None
        if slab_march.lookahead_active(p):
            gate_row, words = time_gate(f"{name} frame 0", teapot, cm0, p, feats, sign)
            base_img = slab_march.render(teapot, cm0, p.replace(use_importance_rendering=False), FULL_H, FULL_W)
            row.update(gate_row, pixels_differing_from_base=float(
                ((img - base_img).abs().amax(-1) > 1e-6).float().mean()))
            if row["pixels_differing_from_base"] <= 0.0:
                raise AssertionError(f"{name}: the frame equals Base: the gate did not engage")
        march_args = (feats, vol, lut, sign, p, grad)
        plane = None if words is None else lookahead.unpack_gate(words, vol.shape[0])
        row.update(
            march_ms=cuda_ms(lambda: slab_march.march_cuda(*march_args, u8=u8, gate=words), 20),
            march_before_ms=parent_ms("slab_march", lambda: slab_march.march_cuda(*march_args, u8=u8, gate=words), 20),
            stage=staged_pairs(feats, vol, grad, u8, p),
            plain_march_ms=cuda_ms(lambda: slab.march_slabs(*march_args, u8, gate=plane), 2),
            frame_ms=cuda_ms(lambda: la_renderers[name](cm0), 10), plain_frame_ms=cuda_ms(plain_frame, 1),
        )
        del plane
        row["rays_per_s"] = FULL_H * FULL_W / (row["frame_ms"] / 1e3)
        if name == "importance_cone":
            row["profile"] = device_profile(lambda: la_renderers[name](cm0), 5)
        la_results[name] = row
        log(f"look-ahead {name}: {json.dumps(row)}")

    # the gate kernels alone: B6 at step .01 (128 resampled planes), and B6
    # and B7 on dense importance, where neither of B6's skips applies
    dense = Scene(volume=teapot.volume, importance=0.5 + 0.5 * teapot.volume, tf_lut=teapot.tf_lut)
    cm0 = la_cams["importance"].matrices()
    gate_alone = {}
    for name, gate_scene, gate_p in (
        ("importance_step01", teapot, la_configs["importance"].replace(raymarching_step_size=0.01)),
        ("dense importance", dense, la_configs["importance"]),
        ("dense importance_cone", dense, la_configs["importance_cone"]),
    ):
        feats, _, _, sign, _, _ = slab_march.prepare(gate_scene, cm0, gate_p, FULL_H, FULL_W)
        gate_alone[name], _ = time_gate(name, gate_scene, cm0, gate_p, feats, sign)
        log(f"gate alone {name}: {json.dumps(gate_alone[name])}")
    del dense

    # phase 5b: importance coloring and first-hit at full size on the teapot,
    # RenderParams()'s defaults (shaded, smoothed, nearest, step .01 -> 128
    # f32 planes) with use_importance_coloring, and with use_opacity off
    mode_configs = {"coloring": RenderParams(use_importance_coloring=True), "first_hit": RenderParams(use_opacity=False)}
    mode_renderers = {name: make_renderer(teapot, p, FULL_H, FULL_W, backend="slab_cuda", device=dev)
                      for name, p in mode_configs.items()}
    mode_frames, mode_counts = {}, {}
    # the coloring and first-hit serving path starts here
    slab_march.LAUNCHES = slab_replay.LAUNCHES = lookahead.STRAIGHT_LAUNCHES = lookahead.CONE_LAUNCHES = 0
    zero_tables()
    cam = Camera(aspect=FULL_W / FULL_H).orbit(2.0, 0.0, 0.0)
    for name, render in mode_renderers.items():
        before = launch_counts()
        for i in range(FRAMES):
            img = render(cam.orbit(2.0 * i, 0.0, 0.0).matrices())
            if i == 0:
                mode_frames[name] = img
        torch.cuda.synchronize()
        mode_counts[name] = tuple(a - b for a, b in zip(launch_counts(), before))
    mode_launches = launch_counts()  # the coloring and first-hit serving path ends here
    mode_tables = read_tables("coloring / first-hit serving", mode_launches[0], mode_launches[2])
    if slab_replay.LAUNCHES or any(c != (FRAMES, 0, 0) for c in mode_counts.values()):
        raise AssertionError(f"coloring / first-hit serving: (march, straight, cone) launches {mode_counts}")
    log(f"coloring / first-hit serving: {mode_launches[0]} march launches for {len(mode_configs) * FRAMES} frames")
    cm0 = cam.matrices()
    mode_results = {}
    for name, p in mode_configs.items():
        img = mode_frames[name]
        if tuple(img.shape) != (FULL_H, FULL_W, 4) or not bool(torch.isfinite(img).all()):
            raise AssertionError(f"{name}: bad frame {tuple(img.shape)}")
        if float((img[..., 3] > 0.5).float().mean()) < 0.05:
            raise AssertionError(f"{name}: the frame is empty")

        def plain_frame(p=p):
            return slab_march.render(teapot, cm0, p, FULL_H, FULL_W, march_fn=slab.march_slabs)

        plain = plain_frame()
        if not torch.equal(plain, img):
            raise AssertionError(f"{name}: frame 0 differs from the plain version by "
                                 f"{float((plain - img).abs().max()):.3e}")
        hold("slab_march", plain, img, f"{name} frame 0 vs plain")
        composited_img = slab_march.render(teapot, cm0, p.replace(use_importance_coloring=False, use_opacity=True),
                                           FULL_H, FULL_W)
        differing = float(((img - composited_img).abs().amax(-1) > 1e-6).float().mean())
        if differing <= 0.0:
            raise AssertionError(f"{name}: the frame equals the TF-composited one")
        del plain, composited_img
        feats, vol, lut, sign, grad, u8 = slab_march.prepare(teapot, cm0, p, FULL_H, FULL_W)
        imp = (slab_march.importance_perm(teapot.importance, slab.dominant_axis(cm0)[0], vol.shape[0]).contiguous()
               if p.use_importance_coloring else None)
        march_args = (feats, vol, lut, sign, p, grad)
        rays = FULL_H * FULL_W
        _, dens = slab.march_slabs(*march_args, u8, emit_density=True, imp_perm=imp)
        threshold = slab.march_knobs(p, u8)[0]
        d0 = dens.reshape(vol.shape[0], -1, rays)[:, 0]
        composited = int((d0 >= threshold).sum())
        stencils = stencil_steps(feats, vol, sign, p, threshold, d0 != 0.0) if p.use_gaussian_smoothing else 0
        del dens, d0
        b1_bound = bound(nbytes(feats, vol, lut, grad, imp) + rays * 16,
                         composited * MARCH_OPS_PER_STEP + stencils * SMOOTH_OPS_PER_STEP)
        row = dict(
            planes=int(vol.shape[0]), u8=u8, march_ms=cuda_ms(lambda: slab_march.march_cuda(
                *march_args, u8=u8, imp_perm=imp), 20),
            plain_march_ms=cuda_ms(lambda: slab.march_slabs(*march_args, u8, imp_perm=imp), 2),
            bound_ms=b1_bound[0], bound_by=b1_bound[1], composited_steps=composited, stencil_steps=stencils,
            stage=staged_pairs(feats, vol, grad, u8, p), frame_ms=cuda_ms(lambda: mode_renderers[name](cm0), 10),
            plain_frame_ms=cuda_ms(plain_frame, 1), pixels_differing_from_composited=differing,
            profile=device_profile(lambda: mode_renderers[name](cm0), 5),
        )
        row["rays_per_s"] = rays / (row["frame_ms"] / 1e3)
        mode_results[name] = row
        log(f"{name} serving: {json.dumps(row)}")

    # phase 6: the training step at full size
    train_p = RenderParams(
        interpolation="trilinear", density_threshold=0.15, raymarching_step_size=0.005,
        use_shading=False, use_gaussian_smoothing=False, u8_volume=True, camera_grads=False,
    )

    def leaf_scene(volume, lut):
        return Scene(volume.clone().requires_grad_(True), scene.importance, lut.clone().requires_grad_(True))

    trainers = {}
    for h, w in TRAIN_SIZES:
        s = leaf_scene(scene.volume, scene.tf_lut)
        cm = Camera(aspect=w / h, distance=1.0).orbit(30.0, 20.0, 0.0).matrices()
        trainers[(h, w)] = (s, cm, make_renderer(s, train_p, h, w, backend="slab_cuda", device=dev, differentiable=True))
    step0 = {}
    slab_march.LAUNCHES = slab_replay.LAUNCHES = 0  # the training path starts here
    zero_tables()
    for (h, w), (s, cm, render) in trainers.items():
        for i in range(TRAIN_STEPS):
            s.volume.grad = s.tf_lut.grad = None
            img = render(cm)
            img.sum().backward()
            if i == 0:
                step0[(h, w)] = (img.detach().clone(), s.volume.grad.clone(), s.tf_lut.grad.clone())
        torch.cuda.synchronize()
    train_launches = (slab_march.LAUNCHES, slab_replay.LAUNCHES)  # the training path ends here
    train_tables = read_tables("training", train_launches[0], 0)
    n_steps = TRAIN_STEPS * len(TRAIN_SIZES)
    if train_launches != (n_steps, n_steps):
        raise AssertionError(f"training: {train_launches} march/replay launches for {n_steps} steps")
    log(f"training: {train_launches[0]} march and {train_launches[1]} replay launches for {n_steps} steps")

    training = {}
    for (h, w), (s, cm, render) in trainers.items():
        rays = h * w
        img, d_vol, d_lut = step0[(h, w)]
        if not (bool(torch.isfinite(img).all()) and bool(torch.isfinite(d_vol).all()) and bool(torch.isfinite(d_lut).all())):
            raise AssertionError(f"training {h}x{w}: non-finite step 0")
        if float(d_vol.abs().max()) <= 0.0 or float(d_lut.abs().max()) <= 0.0:
            raise AssertionError(f"training {h}x{w}: zero gradients")
        ps = leaf_scene(scene.volume, scene.tf_lut)
        plain_img = slab.render_diff(ps, cm, train_p, h, w)
        plain_img.sum().backward()
        agree = {}
        for kernel, name, a, b in (
            ("slab_march", "image", plain_img, img),
            ("slab_replay", "d_volume", ps.volume.grad, d_vol),
        ):
            r, _ = hold(kernel, a, b, f"training {h}x{w} step 0 {name}")
            agree[name] = dict(max_abs_err=r.max_abs_err, scale=r.scale, edge_share=r.edge_frac)
        # d_lut in two groups: its opaque end reaches 1e15 (parity.opaque_entries)
        r, worst = hold("slab_replay", ps.tf_lut.grad, d_lut, f"training {h}x{w} step 0 d_lut", scene.tf_lut)
        opaque = parity.opaque_entries(scene.tf_lut)
        a, b = ps.tf_lut.grad.cpu().double().numpy()[opaque], d_lut.cpu().double().numpy()[opaque]
        agree["d_lut"] = dict(
            max_abs_err=r.max_abs_err, scale=r.scale, edge_share=r.edge_frac, opaque_entries=int(opaque.sum()),
            opaque_max_abs=float(np.abs(a).max(initial=0.0)), opaque_max_abs_err=float(np.abs(a - b).max(initial=0.0)),
            opaque_err_over_magnitude=worst,
        )
        del ps, plain_img

        feats, vol, lut, sign, _, u8 = slab_march.prepare(scene, cm, train_p, h, w)
        stored = slab_replay.use_stored_density(train_p, vol.shape[0], rays)
        if not (u8 and stored):
            raise AssertionError(f"training {h}x{w}: expected the u8 stream and the stored residual")
        out, dens = slab_march.march_cuda(feats, vol, lut, sign, train_p, u8=u8, emit_density=True)
        g = torch.ones_like(out)
        fwd_ms = cuda_ms(lambda: slab_march.march_cuda(feats, vol, lut, sign, train_p, u8=u8, emit_density=True), 10)
        fwd_before_ms = parent_ms("slab_march", lambda: slab_march.march_cuda(
            feats, vol, lut, sign, train_p, u8=u8, emit_density=True), 10)
        zero_ms = cuda_ms(lambda: torch.zeros_like(dens), 10)
        replay_ms = time_replay(f"fused {h}x{w} stored", lambda: slab_replay.replay_cuda(
            feats, vol, lut, sign, train_p, out, g, None, u8, dens))
        replay_resampled_ms = time_replay(f"fused {h}x{w} re-sampled", lambda: slab_replay.replay_cuda(
            feats, vol, lut, sign, train_p, out, g, None, u8))

        def kernel_step():
            s.volume.grad = s.tf_lut.grad = None
            render(cm).sum().backward()

        def plain_step():
            ps = leaf_scene(scene.volume, scene.tf_lut)
            slab.render_diff(ps, cm, train_p, h, w).sum().backward()

        step_ms = cuda_ms(kernel_step, 10)
        busy = device_profile(kernel_step, 5)
        plain_step_ms = cuda_ms(plain_step, 1)
        plain_replay_ms = cuda_ms(lambda: slab.replay_slabs(feats, vol, lut, sign, train_p, out, g, None, u8, dens), 1)
        threshold = slab.march_knobs(train_p, u8)[0]
        composited = int((dens >= threshold).sum())
        read = int((dens != 0.0).sum())
        fwd_bound = bound(nbytes(feats, vol, lut, out, dens), composited * MARCH_OPS_PER_STEP)
        # inputs once, the residual where the replay reads it (the nonzero
        # entries: a lower bound) or the volume, the d_vol and d_lut
        # outputs once
        replay_bound = bound(
            nbytes(feats, lut, out, g) + read * 4 + (vol.numel() + lut.numel()) * 4,
            composited * REPLAY_OPS_PER_STEP,
        )
        replay_resampled_bound = bound(
            nbytes(feats, vol, lut, out, g) + (vol.numel() + lut.numel()) * 4, composited * REPLAY_OPS_PER_STEP)
        training[f"{h}x{w}"] = dict(
            planes=int(vol.shape[0]), stored=stored, residual_mib=dens.numel() * 4 / 2**20,
            fwd_residual_ms=fwd_ms, fwd_residual_before_ms=fwd_before_ms,
            stage=staged_pairs(feats, vol, None, u8, train_p), fwd_bound_ms=fwd_bound[0], fwd_bound_by=fwd_bound[1], zero_fill_ms=zero_ms,
            replay_ms=replay_ms, replay_resampled_ms=replay_resampled_ms, plain_replay_ms=plain_replay_ms,
            replay_bound_ms=replay_bound[0], replay_bound_by=replay_bound[1],
            replay_resampled_bound=replay_resampled_bound,
            step_ms=step_ms, plain_step_ms=plain_step_ms,
            rays_per_s=rays / (step_ms / 1e3), plain_rays_per_s=rays / (plain_step_ms / 1e3),
            composited_steps=composited, step0=agree, profile=busy,
        )
        log(f"training {h}x{w}: {json.dumps(training[f'{h}x{w}'])}")
        del out, dens, g

    # the replay's two routes, B1 + B2 with the residual (its zero-fill
    # included) and without it, in both serving configurations at 1024x768:
    # the shaded f32 one re-samples three more grids
    routes = {}
    for name, p in configs.items():
        p = p.replace(camera_grads=False)
        feats, vol, lut, sign, grad, u8 = slab_march.prepare(scene, cams[name][0].matrices(), p, FULL_H, FULL_W)
        g = torch.ones((FULL_H, FULL_W, 4), dtype=torch.float32, device=dev)

        def stored_route():
            out, dens = slab_march.march_cuda(feats, vol, lut, sign, p, grad, u8=u8, emit_density=True)
            slab_replay.replay_cuda(feats, vol, lut, sign, p, out, g, grad, u8, dens)

        def resampled_route():
            out = slab_march.march_cuda(feats, vol, lut, sign, p, grad, u8=u8)
            slab_replay.replay_cuda(feats, vol, lut, sign, p, out, g, grad, u8)

        routes[name] = dict(
            planes=int(vol.shape[0]), shading=p.use_shading, u8=u8,
            stored_by_the_gate=slab_replay.use_stored_density(p, vol.shape[0], FULL_H * FULL_W),
            stored_ms=cuda_ms(stored_route, 10), resampled_ms=cuda_ms(resampled_route, 10),
        )
    log(f"replay routes at {FULL_H}x{FULL_W}, fwd + bwd kernels: {json.dumps(routes)}")

    # phase 6b: the training step under Gaussian smoothing: B1 with the
    # stencil, B2 unfused with its step range, and B3 or B4 with the
    # stencil's transpose fused in
    gauss_train = {name: configs[name].replace(camera_grads=False) for name in ("bench_gaussian", "cli_default_gaussian")}
    gtrainers = {}
    for name, p in gauss_train.items():
        for h, w in TRAIN_SIZES:
            s = leaf_scene(scene.volume, scene.tf_lut)
            cm = Camera(aspect=w / h, distance=1.0).orbit(30.0, 20.0, 0.0).matrices()
            gtrainers[(name, h, w)] = (p, s, cm, make_renderer(s, p, h, w, backend="slab_cuda", device=dev,
                                                                  differentiable=True))

    def gcounts():
        return (slab_march.LAUNCHES, slab_replay.LAUNCHES, voxel_grad.FOLD_LAUNCHES, voxel_grad.FOLD_SHADED_LAUNCHES,
                voxel_grad.LAUNCHES, voxel_grad.SHADED_LAUNCHES)

    gstep0, gper = {}, {}
    # the smoothed training path starts here
    slab_march.LAUNCHES = slab_replay.LAUNCHES = voxel_grad.LAUNCHES = voxel_grad.SHADED_LAUNCHES = 0
    voxel_grad.FOLD_LAUNCHES = voxel_grad.FOLD_SHADED_LAUNCHES = 0
    zero_tables()
    with NoTranspose():
        for key, (p, s, cm, render) in gtrainers.items():
            before = gcounts()
            for i in range(GAUSS_TRAIN_STEPS):
                s.volume.grad = s.tf_lut.grad = None
                img = render(cm)
                img.sum().backward()
                if i == 0:
                    gstep0[key] = (img.detach().clone(), s.volume.grad.clone(), s.tf_lut.grad.clone())
            torch.cuda.synchronize()
            gper[key] = tuple(a - b for a, b in zip(gcounts(), before))
    gtrain_launches = gcounts()  # the smoothed training path ends here
    gtrain_tables = read_tables("smoothed training", gtrain_launches[0], 0)
    for (name, h, w), launched in gper.items():
        shaded = gauss_train[name].use_shading
        want = (GAUSS_TRAIN_STEPS, GAUSS_TRAIN_STEPS, 0 if shaded else GAUSS_TRAIN_STEPS,
                GAUSS_TRAIN_STEPS if shaded else 0, 0, 0)
        if launched != want:
            raise AssertionError(f"smoothed training {name} {h}x{w}: (march, replay, B3 fold, B4 fold, B3, B4) "
                                 f"launches {launched}, expected {want}")
    log(f"smoothed training: (march, replay, B3 fold, B4 fold, B3, B4) launches {gtrain_launches} for "
        f"{len(gtrainers)} x {GAUSS_TRAIN_STEPS} steps, no plain transpose on the card "
        f"({ {f'{k[0]} {k[1]}x{k[2]}': v for k, v in gper.items()} })")

    gtraining = {}
    for key, (p, s, cm, render) in gtrainers.items():
        name, h, w = key
        rays = h * w
        shaded = p.use_shading
        kernel = "voxel_grad_shaded" if shaded else "voxel_grad"
        label = f"smoothed training {name} {h}x{w}"
        img, d_vol, d_lut = gstep0[key]
        if not (bool(torch.isfinite(img).all()) and bool(torch.isfinite(d_vol).all()) and bool(torch.isfinite(d_lut).all())):
            raise AssertionError(f"{label}: non-finite step 0")
        if float(d_vol.abs().max()) <= 0.0 or float(d_lut.abs().max()) <= 0.0:
            raise AssertionError(f"{label}: zero gradients")

        def plain_step(p=p, cm=cm, h=h, w=w):
            ps = leaf_scene(scene.volume, scene.tf_lut)
            out = slab.render_diff(ps, cm, p, h, w)
            out.sum().backward()
            return out.detach(), ps.volume.grad, ps.tf_lut.grad

        t0 = time.perf_counter()
        plain_img, plain_vol, plain_lut = plain_step()
        torch.cuda.synchronize()
        plain_step_ms = (time.perf_counter() - t0) * 1e3
        if not torch.equal(plain_img, img):
            raise AssertionError(f"{label}: the image differs from the plain step's")
        agree = {}
        r, _ = hold(kernel, plain_vol, d_vol, f"{label} step 0 d_volume")
        agree["d_volume"] = dict(max_abs_err=r.max_abs_err, scale=r.scale, edge_share=r.edge_frac)
        r, worst = hold("slab_replay", plain_lut, d_lut, f"{label} step 0 d_lut", scene.tf_lut)
        agree["d_lut"] = dict(max_abs_err=r.max_abs_err, scale=r.scale, edge_share=r.edge_frac,
                              opaque_err_over_magnitude=worst)
        del plain_img, plain_vol, plain_lut

        feats, vol, lut, sign, grad, u8 = slab_march.prepare(scene, cm, p, h, w)
        stored = slab_replay.use_stored_density(p, vol.shape[0], rays)
        out, dens = slab_march.march_cuda(feats, vol, lut, sign, p, grad, u8=u8, emit_density=True)
        g = torch.ones_like(out)
        dd, steps, _ = slab_replay.replay_cuda(feats, vol, lut, sign, p, out, g, grad, u8, dens)
        # the kernel writes dd only inside each ray's step range: the plain
        # transpose and the scatter without the fold read all of it
        dense = slab.dense_dd(dd, steps)
        dense0 = dense[:, 0] if shaded else dense
        bilinear = p.interpolation.value == "trilinear"
        folded = unfold(feats, dense, vol.shape, p)
        stats = fold_inputs(feats, dense, steps)
        row = dict(
            planes=int(vol.shape[0]), u8=u8, shading=shaded, interpolation=p.interpolation.value,
            route="stored" if stored else "re-sampled", residual_mib=dens.numel() * 4 / 2**20,
            dd_mib=dd.numel() * 4 / 2**20,
            fwd_residual_ms=cuda_ms(lambda: slab_march.march_cuda(feats, vol, lut, sign, p, grad, u8=u8,
                                                                  emit_density=True), 10),
            fwd_ms=cuda_ms(lambda: slab_march.march_cuda(feats, vol, lut, sign, p, grad, u8=u8), 10),
            fwd_residual_before_ms=parent_ms("slab_march", lambda: slab_march.march_cuda(
                feats, vol, lut, sign, p, grad, u8=u8, emit_density=True), 10),
            fwd_before_ms=parent_ms("slab_march", lambda: slab_march.march_cuda(
                feats, vol, lut, sign, p, grad, u8=u8), 10),
            stage=staged_pairs(feats, vol, grad, u8, p),
            replay_stored_ms=time_replay(f"unfused {name} {h}x{w} stored", lambda: slab_replay.replay_cuda(
                feats, vol, lut, sign, p, out, g, grad, u8, dens), smooth=True),
            replay_resampled_ms=time_replay(f"unfused {name} {h}x{w} re-sampled", lambda: slab_replay.replay_cuda(
                feats, vol, lut, sign, p, out, g, grad, u8), smooth=True),
            fold_ms=cuda_ms(lambda: voxel_grad.fold_scatter_cuda(feats, dd, steps, vol.shape, sign, p), 10),
            fold_before_ms=parent_ms("voxel_grad", lambda: voxel_grad.fold_scatter_cuda(
                feats, dd, steps, vol.shape, sign, p), 10),
            # the rows a thread walks: all of its ray's, or chunks of them
            fold_chunks_ms={
                chunk: cuda_ms(lambda chunk=chunk: voxel_grad.fold_scatter_cuda(
                    feats, dd, steps, vol.shape, sign, p, chunk=chunk), 10)
                for chunk in (vol.shape[0], 64, 32, 16, 8)
            },
            unfolded_scatter_ms=cuda_ms(lambda: voxel_grad.scatter_cuda(feats, folded, vol.shape, sign, p), 10),
            plain_transpose_ms=cuda_ms(
                lambda: slab.smooth_dd_transpose(feats, dense0, vol.shape[1], vol.shape[2], bilinear), 1),
            ranges=stats,
        )
        row["plain_transpose_launches"] = device_profile(
            lambda: slab.smooth_dd_transpose(feats, dense0, vol.shape[1], vol.shape[2], bilinear), 1)["device_launches"]
        # the fused kernel (two chunk sizes) and the scatter without the fold against their plain versions
        plain_v, plain_g, plain_rows = slab.smooth_voxel_grad(feats, dense, steps, vol.shape, sign, p, True)
        default_chunk = voxel_grad.fold_chunk(vol.shape[0], h, w)
        row["fold_chunk"] = default_chunk
        for chunk in sorted({default_chunk, 16}):
            d_v, d_g, rows = voxel_grad.fold_scatter_cuda(feats, dd, steps, vol.shape, sign, p, True, chunk)
            torch.cuda.synchronize()
            r, _ = hold(kernel, plain_v, d_v, f"{label} fold d_vol chunk={chunk}")
            if shaded:
                hold(kernel, plain_g, d_g, f"{label} fold d_grad chunk={chunk}")
            inner = (plain_rows[1:-1] == rows[1:-1]).reshape(rows.shape[0] - 2, -1).all(1)
            row[f"fold_check chunk {chunk}"] = dict(
                d_vol_max_abs_err=r.max_abs_err, d_vol_scale=r.scale,
                folded_rows_bitwise=f"{int(inner.sum())}/{inner.numel()}",
                folded_rows_max_abs_err=float((plain_rows - rows).abs().max()))
        fold_out = voxel_grad.fold_scatter_cuda(feats, dd, steps, vol.shape, sign, p)
        row["fold_bound"] = fold_bound(feats, steps, int((plain_rows != 0.0).sum()), fold_out[:2], stats)
        del rows, fold_out
        u_v, u_g = voxel_grad.scatter_cuda(feats, folded, vol.shape, sign, p)
        torch.cuda.synchronize()
        hold(kernel, plain_v, u_v, f"{label} scatter without the fold d_vol")
        if shaded:
            hold(kernel, plain_g, u_g, f"{label} scatter without the fold d_grad")
        del u_v, u_g, plain_rows
        # B2 unfused on both routes against the plain replay
        plain_dd, plain_steps, plain_dl = slab.replay_slabs(feats, vol, lut, sign, p, out, g, grad, u8, dens)
        if not torch.equal(slab.dense_dd(plain_dd, plain_steps), plain_dd):
            raise AssertionError(f"{label}: the plain dd is not 0.0 outside its step range")
        routes_dd = {}
        for route, d in (("stored", dens), ("re-sampled", None)):
            got_dd, got_steps, got_dl = slab_replay.replay_cuda(feats, vol, lut, sign, p, out, g, grad, u8, d)
            if not torch.equal(plain_steps, got_steps):
                raise AssertionError(f"{label} {route}: the step range differs from the plain replay's")
            routes_dd[route] = slab.dense_dd(got_dd, got_steps)
            hold("slab_replay", plain_dd, routes_dd[route], f"{label} {route} replay dd")
            hold("slab_replay", plain_dl, got_dl, f"{label} {route} replay d_lut", lut)
            row[f"replay_{route}_dd_bitwise"] = torch.equal(plain_dd, routes_dd[route])
        if not torch.equal(routes_dd["stored"], routes_dd["re-sampled"]):
            raise AssertionError(f"{label}: the two replay routes give different cotangents")
        del plain_dd, plain_steps, plain_dl, got_dd, got_steps, got_dl, routes_dd
        # index_add_ of the nonzero folded entries' precomputed corners
        idx, vals, size = scatter_indices(feats, folded, vol.shape, sign, p)
        row["fold_library_ms"] = cuda_ms(
            lambda: torch.zeros(size, dtype=torch.float32, device=dev).index_add_(0, idx, vals), 10)
        lib = torch.zeros(size, dtype=torch.float32, device=dev).index_add_(0, idx, vals)
        parity.check_close(lib[: plain_v.numel()].reshape(plain_v.shape), plain_v, f"{label} index_add_ vs plain")
        row["plain_fold_ms"] = cuda_ms(lambda: slab.smooth_voxel_grad(feats, dense, steps, vol.shape, sign, p), 1)
        row["plain_replay_ms"] = cuda_ms(lambda: slab.replay_slabs(feats, vol, lut, sign, p, out, g, grad, u8, dens), 1)
        row["plain_fwd_ms"] = cuda_ms(lambda: slab.march_slabs(feats, vol, lut, sign, p, grad, u8), 1)

        def kernel_step(s=s, render=render, cm=cm):
            s.volume.grad = s.tf_lut.grad = None
            render(cm).sum().backward()

        with NoTranspose():
            row["step_ms"] = cuda_ms(kernel_step, 5)
            row["profile"] = device_profile(kernel_step, 3)
        row["plain_step_ms"] = plain_step_ms
        row["rays_per_s"] = rays / (row["step_ms"] / 1e3)
        if row["profile"]["device_launches"] >= row["plain_transpose_launches"]:
            raise AssertionError(f"{label}: the step launches {row['profile']['device_launches']} device kernels, "
                                 f"the plain transpose alone {row['plain_transpose_launches']}")
        if (h, w) == (FULL_H, FULL_W):
            # the re-sampled route, forced: a zero residual budget
            budget = slab_replay.STORE_DENSITY_BUDGET_MB
            slab_replay.STORE_DENSITY_BUDGET_MB = 0
            try:
                kernel_step()
                torch.cuda.synchronize()
                r, _ = hold(kernel, d_vol, s.volume.grad, f"{label} re-sampled route vs stored d_volume")
                hold("slab_replay", d_lut, s.tf_lut.grad, f"{label} re-sampled route vs stored d_lut", scene.tf_lut)
                row["forced_resampled"] = dict(step_ms=cuda_ms(kernel_step, 5), d_volume_max_abs_err=r.max_abs_err)
            finally:
                slab_replay.STORE_DENSITY_BUDGET_MB = budget

        # bounds: inputs once, outputs once; operations from this run's steps
        threshold = slab.march_knobs(p, u8)[0]
        d0 = dens[:, 0] if shaded else dens
        composited, sampled = int((d0 >= threshold).sum()), int((d0 != 0.0).sum())
        stencils = stencil_steps(feats, vol, sign, p, threshold, d0 != 0.0)
        entries = int((folded != 0.0).sum())
        # with the residual every sampled step runs its stencil; without it,
        # only those whose rows can reach the threshold
        row["fwd_residual_bound"] = bound(nbytes(feats, vol, lut, grad, out, dens),
                                          composited * MARCH_OPS_PER_STEP + sampled * SMOOTH_OPS_PER_STEP)
        row["fwd_bound"] = bound(nbytes(feats, vol, lut, grad, out),
                                 composited * MARCH_OPS_PER_STEP + stencils * SMOOTH_OPS_PER_STEP)
        row["replay_bound"] = replay_bounds(feats, vol, lut, grad, out, g, dens, dd, steps, stats, composited,
                                            stencils)
        row.update(composited_steps=composited, sampled_steps=sampled, stencil_steps=stencils,
                   scatter_entries=entries, step0=agree)
        gtraining[f"{name} {h}x{w}"] = row
        log(f"{label}: {json.dumps(row)}")
        del out, dens, dd, dense, dense0, steps, folded, g, idx, vals, lib, d_v, d_g, plain_v, plain_g

    # phase 6c: the smoothed training step with camera gradients: B1 on f32
    # planes, B2 with its camera chain (re-sampled), B3 or B4 with the
    # transpose fused in (writing the folded rows under trilinear sampling),
    # and B5 under trilinear sampling; autograd carries d_feats to the camera
    cam_train = {name: configs[name].replace(camera_grads=True) for name in ("bench_gaussian", "cli_default_gaussian")}
    cam0 = Camera(aspect=FULL_W / FULL_H, distance=1.0).orbit(30.0, 20.0, 0.0)

    def cam_leaves():
        cm = cam0.matrices()
        cm.inverse_view_proj.requires_grad_(True)
        cm.position.requires_grad_(True)
        return cm

    def camera_grads(cm):
        return {leaf: getattr(cm, leaf).grad for leaf in ("view", "proj", "inverse_view_proj", "position")}

    def ccounts():
        return (slab_march.LAUNCHES, slab_replay.LAUNCHES, voxel_grad.FOLD_LAUNCHES, voxel_grad.FOLD_SHADED_LAUNCHES,
                feats_grad.LAUNCHES, voxel_grad.LAUNCHES + voxel_grad.SHADED_LAUNCHES)

    ctrainers = {}
    for name, p in cam_train.items():
        s = leaf_scene(scene.volume, scene.tf_lut)
        ctrainers[name] = (p, s, make_renderer(s, p, FULL_H, FULL_W, backend="slab_cuda", device=dev,
                                               differentiable=True))
    cstep0, cper = {}, {}
    # the camera-gradient training path starts here
    slab_march.LAUNCHES = slab_replay.LAUNCHES = voxel_grad.LAUNCHES = voxel_grad.SHADED_LAUNCHES = 0
    voxel_grad.FOLD_LAUNCHES = voxel_grad.FOLD_SHADED_LAUNCHES = feats_grad.LAUNCHES = 0
    zero_tables()
    with NoTranspose():
        for name, (p, s, render) in ctrainers.items():
            before = ccounts()
            for i in range(CAM_STEPS):
                s.volume.grad = s.tf_lut.grad = None
                cm = cam_leaves()
                img = render(cm)
                img.sum().backward()
                if i == 0:
                    cstep0[name] = (img.detach().clone(), s.volume.grad.clone(), s.tf_lut.grad.clone(),
                                    camera_grads(cm))
            torch.cuda.synchronize()
            cper[name] = tuple(a - b for a, b in zip(ccounts(), before))
    ctrain_launches = ccounts()  # the camera-gradient training path ends here
    # camera gradients too: the kernel's table (slab_march.KernelTable)
    ctrain_tables = read_tables("camera-gradient training", ctrain_launches[0], 0)
    for name, launched in cper.items():
        p = cam_train[name]
        shaded, tri = p.use_shading, p.interpolation.value == "trilinear"
        want = (CAM_STEPS, CAM_STEPS, 0 if shaded else CAM_STEPS, CAM_STEPS if shaded else 0, CAM_STEPS if tri else 0,
                0)
        if launched != want:
            raise AssertionError(f"camera training {name}: (march, replay, B3 fold, B4 fold, B5 fused into the fold, "
                                 f"B3/B4 without the fold) launches {launched}, expected {want}")
    log(f"camera training: (march, replay, B3 fold, B4 fold, B5 fused into the fold, B3/B4 without the fold) "
        f"launches {ctrain_launches} for {len(ctrainers)} x {CAM_STEPS} steps, no plain transpose or plain chain on "
        f"the card ({cper})")

    ctraining = {}
    for name, (p, s, render) in ctrainers.items():
        rays = FULL_H * FULL_W
        shaded, tri = p.use_shading, p.interpolation.value == "trilinear"
        kernel = "voxel_grad_shaded" if shaded else "voxel_grad"
        label = f"camera training {name} {FULL_H}x{FULL_W}"
        img, d_vol, d_lut, d_cam = cstep0[name]
        if not all(bool(torch.isfinite(t).all()) for t in (img, d_vol, d_lut, d_cam["position"])):
            raise AssertionError(f"{label}: non-finite step 0")
        if float(d_cam["position"].abs().max()) <= 0.0 or d_cam["view"] is not None:
            raise AssertionError(f"{label}: no camera gradient, or one on the view matrix")

        def plain_step(p=p):
            ps = leaf_scene(scene.volume, scene.tf_lut)
            cm = cam_leaves()
            out = slab.render_diff(ps, cm, p, FULL_H, FULL_W)
            out.sum().backward()
            return out.detach(), ps.volume.grad, ps.tf_lut.grad, camera_grads(cm)

        t0 = time.perf_counter()
        plain_img, plain_vol, plain_lut, plain_cam = plain_step()
        torch.cuda.synchronize()
        plain_step_ms = (time.perf_counter() - t0) * 1e3
        if not torch.equal(plain_img, img):
            raise AssertionError(f"{label}: the image differs from the plain step's")
        agree = {}
        r, _ = hold(kernel, plain_vol, d_vol, f"{label} step 0 d_volume")
        agree["d_volume"] = dict(max_abs_err=r.max_abs_err, scale=r.scale, edge_share=r.edge_frac)
        r, worst = hold("slab_replay", plain_lut, d_lut, f"{label} step 0 d_lut", scene.tf_lut)
        agree["d_lut"] = dict(max_abs_err=r.max_abs_err, scale=r.scale, opaque_err_over_magnitude=worst)
        for leaf, r in parity.check_camera_grad(plain_cam, d_cam, f"{label} step 0").items():
            agree[f"d_{leaf}"] = dict(max_abs_err=r.max_abs_err, scale=r.scale)
        del plain_img, plain_vol, plain_lut

        # the kernels on this step's inputs: f32 planes, the replay re-sampled
        cm = cam0.matrices()
        feats, vol, lut, sign, grad, _ = slab_march.prepare(scene, cm, p.replace(u8_volume=False), FULL_H, FULL_W)
        out = slab_march.march_cuda(feats, vol, lut, sign, p, grad)
        g = torch.ones_like(out)
        dd, steps = slab_replay.replay_cuda(feats, vol, lut, sign, p, out, g, grad)[:2]
        dense = slab.dense_dd(dd, steps)  # the kernel writes dd only inside each ray's step range
        dense0 = dense[:, 0] if shaded else dense
        plain_dd = slab.smooth_dd_transpose(feats, dense0, vol.shape[1], vol.shape[2], tri)
        nocam = p.replace(camera_grads=False)
        row = dict(
            planes=int(vol.shape[0]), shading=shaded, interpolation=p.interpolation.value,
            fwd_ms=cuda_ms(lambda: slab_march.march_cuda(feats, vol, lut, sign, p, grad), 10),
            fwd_before_ms=parent_ms("slab_march", lambda: slab_march.march_cuda(feats, vol, lut, sign, p, grad), 10),
            stage=staged_pairs(feats, vol, grad, False, p),
            replay_camera_ms=time_replay(f"camera {name}", lambda: slab_replay.replay_cuda(
                feats, vol, lut, sign, p, out, g, grad), smooth=True),
            replay_no_camera_ms=time_replay(f"camera {name} without the chain", lambda: slab_replay.replay_cuda(
                feats, vol, lut, sign, nocam, out, g, grad), smooth=True),
            plain_transpose_ms=cuda_ms(
                lambda: slab.smooth_dd_transpose(feats, dense0, vol.shape[1], vol.shape[2], tri), 1),
            fold_ms=cuda_ms(lambda: voxel_grad.fold_scatter_cuda(feats, dd, steps, vol.shape, sign, p), 10),
            fold_before_ms=parent_ms("voxel_grad", lambda: voxel_grad.fold_scatter_cuda(
                feats, dd, steps, vol.shape, sign, p), 10),
            ranges=fold_inputs(feats, dense, steps),
        )
        # B2's bound with and without the chain, from this step's composited
        # steps and the stencils that run (the forward's residual counts them)
        dens = slab_march.march_cuda(feats, vol, lut, sign, nocam, grad, emit_density=True)[1]
        d0 = dens[:, 0] if shaded else dens
        threshold = slab.march_knobs(p, False)[0]
        composited = int((d0 >= threshold).sum())
        stencils = stencil_steps(feats, vol, sign, p, threshold, d0 != 0.0)
        del dens, d0
        # d_feats' rows written: F_AEXP, F_HX..F_HZ when shaded, F_RS..F_CB and F_TS when trilinear
        chain_rows = 1 + 3 * shaded + 5 * tri
        # (the chain's F_TS term is a second stencil a composited step)
        with_chain = replay_bounds(feats, vol, lut, grad, out, g, None, dd, steps, row["ranges"], composited,
                                   stencils, chain_rows, composited * SMOOTH_OPS_PER_STEP if tri else 0)
        row.update(replay_bound=with_chain["re-sampled"], replay_whole_dd_bound=with_chain["re-sampled whole dd"],
                   replay_no_camera_bound=replay_bounds(feats, vol, lut, grad, out, g, None, dd, steps, row["ranges"],
                                                        composited, stencils)["re-sampled"])
        if tri:
            # B5 fused into the fold, the main path's one launch: against the
            # plain composition (one chunk of rows at this size: bit for bit)
            b5, bits = hold_chain(feats, dd, steps, vol, sign, p, label)
            plain_b5 = slab.feats_grad(feats, vol, plain_dd, sign, p)
            r, _ = hold("feats_grad", plain_b5, b5, f"{label} B5 fused")
            rows_k = voxel_grad.fold_scatter_cuda(feats, dd, steps, vol.shape, sign, p, True)[2]
            inner = (plain_dd[1:-1] == rows_k[1:-1]).reshape(plain_dd.shape[0] - 2, -1).all(1)
            row["folded_rows_bitwise"] = f"{int(inner.sum())}/{inner.numel()}"
            hold("voxel_grad_shaded" if shaded else "voxel_grad", plain_dd, rows_k, f"{label} folded rows")
            del rows_k
            # B5's own work, recounted on this run's data: the nonzero folded
            # entries and 4 table rows read, the distinct texels its taps
            # touch, 4 rows of d_feats written; the fused kernel's: the fold's
            # and the chain's texels, operations and d_feats rows
            entries = int((plain_dd != 0.0).sum())
            texels = chain_texels(feats, plain_dd, vol.shape, sign, p)
            outs = voxel_grad.fold_scatter_cuda(feats, dd, steps, vol.shape, sign, p)[:2]
            fused_bound = fold_bound(feats, steps, entries, outs, row["ranges"], extra_bytes=texels * 4 + 4 * rays * 4,
                                     extra_ops=entries * CHAIN_OPS_PER_ROW)
            fold_only = fold_bound(feats, steps, entries, outs, row["ranges"])
            del outs
            row.update(
                chain_ms=cuda_ms(lambda: voxel_grad.fold_scatter_cuda(feats, dd, steps, vol.shape, sign, p, vol=vol),
                                 10),
                # the plain version: the plain fold with its folded rows, then the plain chain on them
                plain_chain_ms=cuda_ms(lambda: slab.feats_grad(feats, vol, slab.smooth_voxel_grad(
                    feats, dense, steps, vol.shape, sign, p, True)[2], sign, p), 1),
                plain_feats_grad_ms=cuda_ms(lambda: slab.feats_grad(feats, vol, plain_dd, sign, p), 1),
                chain_bound=bound(entries * 4 + 2 * 4 * rays * 4 + texels * 4, entries * CHAIN_OPS_PER_ROW),
                chain_entries=entries, chain_texels=texels, fused_bound=fused_bound, fold_alone_bound=fold_only,
                chain_max_abs_err=r.max_abs_err, chain_scale=r.scale, chain_bitwise=bits,
            )
            # the parent's route: the (N, H, W) folded rows zero-filled, its
            # fold writing them, its B5 walking all of them
            before = {}
            for parent in parents:
                (_, _, p_feats), parts = parent.chain(feats, dense, steps, vol, sign, p)
                torch.cuda.synchronize()
                pr, _ = hold("feats_grad", plain_b5, p_feats, f"{label} --parent {parent.label} B5")
                before[parent.label] = dict(ms={part: cuda_ms(fn, 10) for part, fn in parts.items()},
                                            max_abs_err=pr.max_abs_err)
            row["chain_before"] = before or None
            # the NaN-filled dd outside each step range: the chain reads none of it
            own_alloc = slab_replay.ALLOC_DD
            slab_replay.ALLOC_DD = lambda shape, **kw: torch.full(shape, float("nan"), **kw)
            try:
                nan_dd, nan_steps = slab_replay.replay_cuda(feats, vol, lut, sign, p, out, g, grad)[:2]
            finally:
                slab_replay.ALLOC_DD = own_alloc
            outside = slab.dense_dd(torch.ones_like(nan_dd), nan_steps) == 0.0
            if not (bool(outside.any()) and bool(nan_dd[outside].isnan().all())):
                raise AssertionError(f"{label}: the NaN fill did not stay outside the step ranges")
            nan_out = voxel_grad.fold_scatter_cuda(feats, nan_dd, nan_steps, vol.shape, sign, p, vol=vol)
            torch.cuda.synchronize()
            if not all(bool(torch.isfinite(t).all()) for t in nan_out if t is not None):
                raise AssertionError(f"{label}: the fused chain read the NaN outside the step ranges")
            hold("feats_grad", b5, nan_out[2], f"{label} B5 fused on a NaN-filled dd")
            row["nan_filled_dd_bitwise"] = torch.equal(b5, nan_out[2])
            del b5, plain_b5, nan_dd, nan_steps, nan_out, outside

        def kernel_step(s=s, render=render):
            s.volume.grad = s.tf_lut.grad = None
            render(cam_leaves()).sum().backward()

        nocam_render = make_renderer(s, nocam, FULL_H, FULL_W, backend="slab_cuda", device=dev, differentiable=True)

        def nocam_step(s=s):
            s.volume.grad = s.tf_lut.grad = None
            nocam_render(cam0.matrices()).sum().backward()

        with NoTranspose():
            row.update(
                step_ms=cuda_ms(kernel_step, 5), no_camera_step_ms=cuda_ms(nocam_step, 5), plain_step_ms=plain_step_ms,
                profile=device_profile(kernel_step, 3), step0=agree,
            )
        # one step's peak memory; with the chain, beside the step whose fold
        # writes the (N, H, W) folded rows for a B5 that walks them (each
        # --parent's own kernels where it has its own B5, else this fold's
        # rows and the plain chain)
        row["step_peak_mb"] = peak_mb(kernel_step)
        if tri:
            route = next(((parent.label, parent.scatter_fn, parent.feats_grad_fn) for parent in parents
                          if parent.b5 is not None), ("folded rows", voxel_grad.fold_scatter_cuda, slab.feats_grad))

            def rows_step(s=s, route=route):
                s.volume.grad = s.tf_lut.grad = None
                slab_march.render_diff(s, cam_leaves(), p, FULL_H, FULL_W, scatter_fn=route[1],
                                       feats_grad_fn=route[2]).sum().backward()

            row["folded_rows_step_peak_mb"] = dict(route=route[0], mb=peak_mb(rows_step))
            folded_mb = vol.shape[0] * rays * 4 / 1e6
            saved = row["folded_rows_step_peak_mb"]["mb"] - row["step_peak_mb"]
            if saved < folded_mb - 64.0:
                raise AssertionError(f"{label}: the step's peak is {saved:.1f} MB below the folded rows' route's, "
                                     f"expected about {folded_mb:.1f} MB (the (N, H, W) folded rows)")
        ctraining[name] = row
        log(f"{label}: {json.dumps(row)}")
        del out, g, dd, dense, dense0, steps, plain_dd

    # phase 6d: the training steps of the new modes at 1024x768 on the teapot:
    # Importance and ImportanceCone (the sweep preset: shaded, nearest, no
    # smoothing, 256 planes; u8 and the stored residual without camera
    # gradients where it fits the budget, f32 and the re-sampled replay with
    # them), the gate built once a step and read by B1 and B2; and importance
    # coloring with RenderParams()'s defaults (shaded, smoothed; no camera
    # gradients), d_importance through B2's coloring mode, nothing folded
    mode_train = {
        "importance": la_configs["importance"].replace(camera_grads=False),
        "importance camera": la_configs["importance"].replace(camera_grads=True),
        "importance_cone": la_configs["importance_cone"].replace(camera_grads=False),
        "importance_cone camera": la_configs["importance_cone"].replace(camera_grads=True),
        "coloring": RenderParams(use_importance_coloring=True, camera_grads=False),
    }
    cm_train = Camera(aspect=FULL_W / FULL_H, distance=1.0).orbit(30.0, 20.0, 0.0)

    def mode_leaves(p):
        s = Scene(teapot.volume.clone().requires_grad_(True), teapot.importance.clone().requires_grad_(True),
                  teapot.tf_lut.clone().requires_grad_(True))
        cm = cm_train.matrices()
        if p.camera_grads:
            cm.inverse_view_proj.requires_grad_(True)
            cm.position.requires_grad_(True)
        return s, cm

    def mcounts():
        return (slab_march.LAUNCHES, slab_replay.LAUNCHES, lookahead.STRAIGHT_LAUNCHES, lookahead.CONE_LAUNCHES,
                voxel_grad.FOLD_LAUNCHES + voxel_grad.FOLD_SHADED_LAUNCHES + voxel_grad.LAUNCHES
                + voxel_grad.SHADED_LAUNCHES + feats_grad.LAUNCHES)

    mstep0, mper = {}, {}
    # the new modes' training path starts here
    slab_march.LAUNCHES = slab_replay.LAUNCHES = lookahead.STRAIGHT_LAUNCHES = lookahead.CONE_LAUNCHES = 0
    voxel_grad.LAUNCHES = voxel_grad.SHADED_LAUNCHES = voxel_grad.FOLD_LAUNCHES = voxel_grad.FOLD_SHADED_LAUNCHES = 0
    feats_grad.LAUNCHES = 0
    zero_tables()
    for name, p in mode_train.items():
        before = mcounts()
        for i in range(MODE_STEPS):
            s, cm = mode_leaves(p)
            img = make_renderer(s, p, FULL_H, FULL_W, backend="slab_cuda", device=dev, differentiable=True)(cm)
            img.sum().backward()
            if i == 0:
                mstep0[name] = (img.detach().clone(), s.volume.grad, s.tf_lut.grad, s.importance.grad,
                                cm.position.grad)
        torch.cuda.synchronize()
        mper[name] = tuple(a - b for a, b in zip(mcounts(), before))
    mtrain_launches = mcounts()  # the new modes' training path ends here
    mtrain_tables = read_tables("mode training", mtrain_launches[0], mtrain_launches[3])
    for name, p in mode_train.items():
        cone = p.use_cone_importance_check and not p.use_importance_coloring
        straight = p.use_importance_rendering and not cone and not p.use_importance_coloring
        want = (MODE_STEPS, MODE_STEPS, MODE_STEPS * straight, MODE_STEPS * cone, 0)
        if mper[name] != want:
            raise AssertionError(f"mode training {name}: (march, replay, straight, cone, B3-B5) launches "
                                 f"{mper[name]}, expected {want}")
    log(f"mode training: (march, replay, straight, cone, B3-B5) launches {mtrain_launches} for {len(mode_train)} x "
        f"{MODE_STEPS} steps ({mper})")

    mtraining = {}
    for name, p in mode_train.items():
        rays = FULL_H * FULL_W
        coloring = p.use_importance_coloring
        label = f"mode training {name} {FULL_H}x{FULL_W}"
        img, d_vol, d_lut, d_imp, d_pos = mstep0[name]
        finite = [img, d_vol, d_lut] + ([d_imp] if coloring else []) + ([d_pos] if p.camera_grads else [])
        if not all(bool(torch.isfinite(t).all()) for t in finite):
            raise AssertionError(f"{label}: non-finite step 0")
        if coloring:
            if float(d_imp.abs().max()) <= 0.0 or bool(d_lut.any()):
                raise AssertionError(f"{label}: no d_importance, or a LUT gradient")
        elif d_imp is not None or float(d_vol.abs().max()) <= 0.0:
            raise AssertionError(f"{label}: a gradient on the importance, or none on the volume")
        if p.camera_grads and float(d_pos.abs().max()) <= 0.0:
            raise AssertionError(f"{label}: no camera gradient")

        def plain_step(p=p):
            ps, cm = mode_leaves(p)
            out = slab.render_diff(ps, cm, p, FULL_H, FULL_W)
            out.sum().backward()
            return out.detach(), ps.volume.grad, ps.tf_lut.grad, ps.importance.grad, cm.position.grad

        t0 = time.perf_counter()
        want = plain_step()
        torch.cuda.synchronize()
        plain_step_ms = (time.perf_counter() - t0) * 1e3
        if not torch.equal(want[0], img):
            raise AssertionError(f"{label}: the image differs from the plain step's by "
                                 f"{float((want[0] - img).abs().max()):.3e}")
        agree = {}
        for i, what in ((1, "d_volume"), (3, "d_importance"), (4, "d_position")):
            if want[i] is not None:
                r, _ = hold("slab_replay", want[i], mstep0[name][i], f"{label} step 0 {what}")
                agree[what] = dict(max_abs_err=r.max_abs_err, scale=r.scale, edge_share=r.edge_frac)
        if not coloring:
            r, worst = hold("slab_replay", want[2], d_lut, f"{label} step 0 d_lut", teapot.tf_lut)
            agree["d_lut"] = dict(max_abs_err=r.max_abs_err, scale=r.scale, opaque_err_over_magnitude=worst)
        del want

        # the kernels on this step's inputs
        cm = cm_train.matrices()
        feats, vol, lut, sign, grad, u8 = slab_march.prepare(teapot, cm, p, FULL_H, FULL_W)
        u8 = u8 and not p.camera_grads
        if not u8:
            feats, vol, lut, sign, grad, _ = slab_march.prepare(teapot, cm, p.replace(u8_volume=False), FULL_H,
                                                                FULL_W)
        words = plane = imp = None
        gate_ms = None
        if coloring:
            imp = slab_march.importance_perm(teapot.importance, slab.dominant_axis(cm)[0], vol.shape[0]).contiguous()
        else:
            cone_feats, levels = slab_march.lookahead_inputs(teapot, cm, p, FULL_H, FULL_W)
            words = lookahead.gate_cuda(feats, cone_feats, levels, sign, p.subtexel_bits)
            plane = lookahead.unpack_gate(words, vol.shape[0])
            gate_ms = cuda_ms(lambda: lookahead.gate_cuda(feats, cone_feats, levels, sign, p.subtexel_bits), 10)
        stored = slab_replay.use_stored_density(p, vol.shape[0], rays)
        march_args = (feats, vol, lut, sign, p, grad)
        res = slab_march.march_cuda(*march_args, u8=u8, emit_density=stored, gate=words, imp_perm=imp)
        out, dens = res if stored else (res, None)
        g = torch.ones_like(out)
        _, resid = slab.march_slabs(*march_args, u8, emit_density=True, gate=plane, imp_perm=imp)
        threshold = slab.march_knobs(p, u8)[0]
        d0 = resid.reshape(vol.shape[0], -1, rays)[:, 0]
        composited = int((d0 >= threshold).sum())
        stencils = stencil_steps(feats, vol, sign, p, threshold, d0 != 0.0) if p.use_gaussian_smoothing else 0
        del resid, d0
        # inputs once, outputs once: d_vol (d_imp under coloring) as f32, d_lut,
        # d_grad when shaded, d_feats with camera gradients
        ins = nbytes(feats, vol, lut, grad, imp, words)
        outs = vol.numel() * 4 + nbytes(lut, grad) + (nbytes(feats) if p.camera_grads else 0)
        b1_bound = bound(ins + nbytes(out, dens), composited * MARCH_OPS_PER_STEP + stencils * SMOOTH_OPS_PER_STEP)
        b2_bound = bound(ins + nbytes(out, g, dens) + outs,
                         composited * REPLAY_OPS_PER_STEP + stencils * SMOOTH_OPS_PER_STEP)
        s_k, cm_k = mode_leaves(p)
        render_k = make_renderer(s_k, p, FULL_H, FULL_W, backend="slab_cuda", device=dev, differentiable=True)

        def kernel_step(s=s_k, cm=cm_k, render=render_k):
            for t in (s.volume, s.tf_lut, s.importance, cm.inverse_view_proj, cm.position):
                t.grad = None
            render(cm).sum().backward()

        row = dict(
            planes=int(vol.shape[0]), u8=u8, stored=stored, shading=p.use_shading,
            smoothing=p.use_gaussian_smoothing, camera_grads=p.camera_grads, gate_ms=gate_ms,
            march_ms=cuda_ms(lambda: slab_march.march_cuda(*march_args, u8=u8, emit_density=stored, gate=words,
                                                           imp_perm=imp), 10),
            march_bound=b1_bound, stage=staged_pairs(feats, vol, grad, u8, p),
            replay_ms=cuda_ms(lambda: slab_replay.replay_cuda(feats, vol, lut, sign, p, out, g, grad, u8, dens, words,
                                                              imp), 10),
            plain_replay_ms=cuda_ms(lambda: slab.replay_slabs(feats, vol, lut, sign, p, out, g, grad, u8, dens, plane,
                                                              imp), 1),
            replay_bound=b2_bound, composited_steps=composited, stencil_steps=stencils,
            step_ms=cuda_ms(kernel_step, 5), plain_step_ms=plain_step_ms, profile=device_profile(kernel_step, 3),
            step0=agree,
        )
        mtraining[name] = row
        log(f"{label}: {json.dumps(row)}")
        del out, dens, g, plane

    # phase 7: a few descent steps on the f32 stream
    fit_p = train_p.replace(u8_volume=False)
    dh, dw = TRAIN_SIZES[0]
    cm = Camera(aspect=dw / dh, distance=1.0).orbit(30.0, 20.0, 0.0).matrices()
    target = make_renderer(scene, fit_p, dh, dw, backend="slab_cuda", device=dev)(cm).detach()
    fit = leaf_scene(torch.full_like(scene.volume, max(0.15, fit_p.density_threshold + 0.03)), scene.tf_lut)
    render = make_renderer(fit, fit_p, dh, dw, backend="slab_cuda", device=dev, differentiable=True)
    opt = torch.optim.Adam([fit.volume, fit.tf_lut], lr=1e-2)
    losses = []
    for _ in range(DESCENT_STEPS):
        opt.zero_grad()
        loss = torch.mean((render(cm) - target) ** 2)
        loss.backward()
        opt.step()
        with torch.no_grad():
            fit.volume.clamp_(0.0, 1.0)
            fit.tf_lut.clamp_(0.0, 1.0)
        losses.append(loss.item())
    log(f"descent: {DESCENT_STEPS} Adam steps at {dh}x{dw}, loss {losses[0]:.6f} -> {losses[-1]:.6f}")
    if not (all(map(lambda x: x == x, losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"descent: the loss did not fall ({losses})")

    # phase 8: the CLI
    with tempfile.TemporaryDirectory() as tmp:
        for flags in ([], ["--importance", "--cone", "--scene", "teapot"], ["--coloring", "--scene", "teapot"],
                      ["--first-hit"]):
            out = Path(tmp) / "shot.png"
            before = launch_counts()
            rc = cli.main(["screenshot", *flags, "--output", str(out)])
            data = out.read_bytes() if out.exists() else b""
            if rc != 0 or data[:8] != b"\x89PNG\r\n\x1a\n":
                raise AssertionError(f"CLI screenshot {flags} failed (rc {rc}, {len(data)} bytes)")
            launched = tuple(a - b for a, b in zip(launch_counts(), before))
            if launched != ((1, 0, 1) if "--cone" in flags else (1, 0, 0)):
                raise AssertionError(f"CLI screenshot {flags}: (march, straight, cone) launches {launched}")
            out.unlink()
            log(f"cli: screenshot {' '.join(flags)} (smoothing on) wrote a {len(data)}-byte PNG; "
                f"(march, straight, cone) launches {launched}")

    # phase 9: the t-step renderers (backend "ray"), PyTorch ops: they must
    # launch none of the kernels above
    def all_counts():
        return (slab_march.LAUNCHES, slab_replay.LAUNCHES, lookahead.STRAIGHT_LAUNCHES, lookahead.CONE_LAUNCHES,
                voxel_grad.LAUNCHES, feats_grad.LAUNCHES)

    before = all_counts()
    tstep = tstep_path(dev, scene, teapot)
    if all_counts() != before:
        raise AssertionError(f"the t-step path launched kernels: {before} -> {all_counts()}")
    log(json.dumps({"tstep": tstep}))

    # phase 10: the CLI's benchmark (its sweep is a main path of B1, B6 and
    # B7), fit and run --live-sweep; the harness's host clock; fit_scene
    cli_rec, sweep_launches = cli_path(dev, scene)
    log(json.dumps({"cli": cli_rec}))

    # phase 11: distribution (a one-rank NCCL group, sharded frames and
    # training steps, fit_distributed, the CLI's fit --distributed and
    # benchmark --scaling) and the viewer: a main path of B1, B2, B3, B5, B7
    dist_rec, dist_launches = distributed_path(dev, scene, teapot)
    log(json.dumps({"distributed": dist_rec}))

    # B2 in every route and cell: ms, each --parent checkout's ms on the
    # same inputs (with the zero-fill its wrapper did; under smoothing also
    # with dd by torch.empty), the bound (and the bound with all of dd
    # written), and what share of the first checkout's time each later one
    # and the first one's zero-fill save
    for key, row in training.items():
        b2[f"fused {key} stored"]["bound"] = [row["replay_bound_ms"], row["replay_bound_by"]]
        b2[f"fused {key} re-sampled"]["bound"] = row["replay_resampled_bound"]
    for key, row in gtraining.items():
        for route in ("stored", "re-sampled"):
            b2[f"unfused {key} {route}"].update(bound=row["replay_bound"][route],
                                                whole_dd_bound=row["replay_bound"][f"{route} whole dd"])
    for name, row in ctraining.items():
        b2[f"camera {name}"].update(bound=row["replay_bound"], whole_dd_bound=row["replay_whole_dd_bound"])
        b2[f"camera {name} without the chain"]["bound"] = row["replay_no_camera_bound"]
    if parents:
        for row in b2.values():
            first = row["before"][0]
            shares = {parent.label: 1.0 - t / first for parent, t in zip(parents[1:], row["before"][1:])}
            if "before_empty" in row:
                shares["zero-fill"] = 1.0 - row["before_empty"][0] / first
            row["shares_of_first_parent"] = shares
    log(json.dumps({"B2_ms_after_before": b2, "parents": [parent.label for parent in parents] or None}))

    # B1, B6 and B7 in every cell where they run: ms, each --parent
    # checkout's ms on the same inputs, and B1's staged share
    cells = {}
    for name, row in results.items():
        cells[f"serving {name}"] = dict(B1=[row["march_ms"], row["march_before_ms"]], stage=row["stage"])
    gate_key = {"lookahead_straight": "B6", "lookahead_cone": "B7"}
    for name, row in la_results.items():
        cells[f"look-ahead {name}"] = dict(B1=[row["march_ms"], row["march_before_ms"]], stage=row["stage"])
        if "kernel" in row:
            cells[f"look-ahead {name}"][gate_key[row["kernel"]]] = [row["gate_ms"], row["gate_before_ms"]]
    for name, row in gate_alone.items():
        cells[f"gate alone {name}"] = {gate_key[row["kernel"]]: [row["gate_ms"], row["gate_before_ms"]]}
    for name, row in training.items():
        cells[f"training {name}"] = dict(B1_residual=[row["fwd_residual_ms"], row["fwd_residual_before_ms"]],
                                         stage=row["stage"])
    for name, row in gtraining.items():
        cells[f"smoothed training {name}"] = dict(B1=[row["fwd_ms"], row["fwd_before_ms"]],
                                                  B1_residual=[row["fwd_residual_ms"], row["fwd_residual_before_ms"]],
                                                  stage=row["stage"])
    for name, row in ctraining.items():
        cells[f"camera training {name}"] = dict(B1=[row["fwd_ms"], row["fwd_before_ms"]], stage=row["stage"])
    for name, row in mode_results.items():  # no --parent kernel has these modes
        cells[f"{name} serving"] = dict(B1=[row["march_ms"], None], stage=row["stage"])
    for name, row in mtraining.items():
        cells[f"mode training {name}"] = dict(B1=[row["march_ms"], None], stage=row["stage"])
        if row["gate_ms"] is not None:
            cells[f"mode training {name}"]["B7" if "cone" in name else "B6"] = [row["gate_ms"], None]
    log(json.dumps({"B1_B6_B7_ms_after_before": cells, "B7_occupancy": cone_occupancy,
                    "parent": args.parent or None}))

    bench, step = results["bench"], training[f"{FULL_H}x{FULL_W}"]
    rows = {
        "slab_march": dict(
            launches=serving_launches + la_launches[0] + train_launches[0], ms=bench["march_ms"],
            plain_ms=bench["plain_march_ms"], bound_ms=bench["bound_ms"], bound_by=bench["bound_by"],
        ),
        "slab_replay": dict(
            launches=train_launches[1], ms=step["replay_ms"], plain_ms=step["plain_replay_ms"],
            bound_ms=step["replay_bound_ms"], bound_by=step["replay_bound_by"],
        ),
    }
    for kernel, name, launches in (("lookahead_straight", "importance", la_launches[1]),
                                   ("lookahead_cone", "importance_cone", la_launches[2])):
        la = la_results[name]
        rows[kernel] = dict(launches=launches, ms=la["gate_ms"], plain_ms=la["plain_gate_ms"],
                            bound_ms=la["gate_bound_ms"], bound_by=la["gate_bound_by"])
        if "gate_bound_old_count" in la:
            rows[kernel]["bound_ms_old_count"] = la["gate_bound_old_count"][0]
    # B3 and B4 (the fused fold-and-scatter) at 1024x768 in the smoothed
    # bench step and CLI default; the plain version is the transpose and the
    # scatter
    for kernel, name, launches in (("voxel_grad", "bench_gaussian", gtrain_launches[2]),
                                   ("voxel_grad_shaded", "cli_default_gaussian", gtrain_launches[3])):
        g = gtraining[f"{name} {FULL_H}x{FULL_W}"]
        rows[kernel] = dict(launches=launches, ms=g["fold_ms"], plain_ms=g["plain_fold_ms"],
                            bound_ms=g["fold_bound"][0], bound_by=g["fold_bound"][1],
                            library_ms=g["fold_library_ms"],
                            library="index_add_ of the nonzero folded entries' precomputed corner indices and "
                                    "weights, their computation excluded",
                            extra=dict(before_ms=g["fold_before_ms"]))
    rows["slab_march"]["launches"] += gtrain_launches[0] + ctrain_launches[0] + mode_launches[0] + mtrain_launches[0]
    rows["slab_replay"]["launches"] += gtrain_launches[1] + ctrain_launches[1] + mtrain_launches[1]
    rows["lookahead_straight"]["launches"] += mtrain_launches[2]
    rows["lookahead_cone"]["launches"] += mtrain_launches[3]
    # the tables' kernels: one launch a march and one a cone gate on every
    # main path (read_tables)
    path_tables = (serving_tables, la_tables, mode_tables, train_tables, gtrain_tables, ctrain_tables, mtrain_tables)
    for kernel, n in zip(("ray_table", "cone_table"), map(sum, zip(*path_tables))):
        rows[kernel] = dict(launches=n, **tables[kernel])
    for kernel, n in zip(("slab_march", "lookahead_straight", "lookahead_cone", "ray_table", "cone_table"),
                         sweep_launches):
        rows[kernel]["launches"] += n
    # the modes of this slice: B1's coloring and first-hit frames, and B1
    # and B2 in the gated and coloring training steps, each with its bound
    rows["slab_march"]["modes"] = {
        **{f"{name} frame": dict(ms=row["march_ms"], plain_ms=row["plain_march_ms"], bound_ms=row["bound_ms"],
                                 bound_by=row["bound_by"]) for name, row in mode_results.items()},
        **{f"{name} step": dict(ms=row["march_ms"], bound_ms=row["march_bound"][0], bound_by=row["march_bound"][1])
           for name, row in mtraining.items()},
    }
    rows["slab_replay"]["modes"] = {
        f"{name} step": dict(ms=row["replay_ms"], plain_ms=row["plain_replay_ms"], bound_ms=row["replay_bound"][0],
                             bound_by=row["replay_bound"][1]) for name, row in mtraining.items()}
    rows["voxel_grad"]["launches"] += ctrain_launches[2]
    rows["voxel_grad_shaded"]["launches"] += ctrain_launches[3]
    # B5, fused into B3's fold, at 1024x768 in the smoothed bench step with
    # camera gradients: the fused kernel's time and bound (its plain version
    # the plain fold and the plain chain), B5's own recounted bound, the
    # fold's time without the chain, and each --parent's route
    c = ctraining["bench_gaussian"]
    rows["feats_grad"] = dict(launches=ctrain_launches[4], ms=c["chain_ms"], plain_ms=c["plain_chain_ms"],
                              bound_ms=c["fused_bound"][0], bound_by=c["fused_bound"][1],
                              extra=dict(chain_bound_ms=c["chain_bound"][0], chain_bound_by=c["chain_bound"][1],
                                         fold_without_chain_ms=c["fold_ms"], plain_feats_grad_ms=c["plain_feats_grad_ms"],
                                         step_peak_mb=c["step_peak_mb"],
                                         folded_rows_step_peak_mb=c["folded_rows_step_peak_mb"],
                                         before=c["chain_before"]))
    for kernel, n in dist_launches.items():
        rows[kernel]["launches"] += n
    log(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": KERNELS[name][0], "replaces": KERNELS[name][1],
         "launches": row["launches"], "max_abs_err": err[name], "max_rel_err": rel[name],
         "ms": row["ms"], "plain_ms": row["plain_ms"],
         "bound_ms": row["bound_ms"], "bound_by": row["bound_by"], "library_ms": row.get("library_ms"),
         **({"library": row["library"]} if "library" in row else {}),
         **({"modes": row["modes"]} if "modes" in row else {}),
         **({"bound_ms_old_count": row["bound_ms_old_count"]} if "bound_ms_old_count" in row else {}),
         **row.get("extra", {})}
        for name, row in rows.items()
    ]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
