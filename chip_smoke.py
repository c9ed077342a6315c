#!/usr/bin/env python3
"""Drive volym_tpu_torch once on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, in order; any failure ends the run with a nonzero exit:

1. require CUDA and print the card's name and power limit;
2. build the CUDA kernels from ``volym_tpu_torch/ops/csrc`` (one nvcc per
   source, all started together): the march (B1) and the replay (B2);
3. hold the kernels to their plain PyTorch versions on the card: 64^3
   synthetic bonsai, 96x64 rays, every (major axis, sign) view x {nearest,
   trilinear} x {u8 native planes, f32 resampled planes} x {shaded,
   unshaded}: the march (48 cases), the march with its stored-density
   residual, bit for bit (48), and the replay from the residual and
   re-sampled (96), whose two routes must also agree;
4. serving: render the 256^3 synthetic bonsai at 1024x768 through
   ``make_renderer(..., backend="slab_cuda")``, 10 orbit frames 2 degrees
   apart in each of two configurations (the bench forward: trilinear, u8,
   threshold .15, step .005 -> 256 planes, unshaded; the CLI default without
   smoothing: nearest, threshold .12, step .01 -> 128 resampled f32 planes,
   shaded).  The march's launch count shows the frames went through it;
   frame 0 is checked against the plain version; the kernel and the plain
   version are timed with CUDA events;
5. training: the ``bench.py`` step, ``sum(render_diff)`` with gradients for
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
   in both serving configurations;
6. descent: 20 Adam steps (lr 1e-2, clamped to [0, 1]) on the volume and
   the LUT from a flat volume towards an image of the bonsai, on the f32
   stream (u8_volume=False, as fitting requires); the loss must fall;
7. write a screenshot through the CLI.

The second-to-last line is a JSON summary of the kernels; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

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
DESCENT_STEPS = 20
ORBITS = [(30.0, 20.0), (210.0, 20.0), (120.0, 10.0), (300.0, -10.0), (20.0, 70.0), (20.0, -70.0)]
KERNELS = {
    "slab_march": ("volym_tpu_torch/ops/csrc/slab_march.cu", "volym_tpu/ops/slab_kernel.py:91"),
    "slab_replay": ("volym_tpu_torch/ops/csrc/slab_replay.cu", "volym_tpu/ops/slab_bwd_kernel.py:169"),
}
#: H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and f32 operations/s
#: outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
#: f32 operations of one composited step, counted from the kernel sources
#: (a transcendental counts as one): the unshaded march step, and the
#: unshaded replay step with its TF chain and 4-tap scatter
MARCH_OPS_PER_STEP = 70
REPLAY_OPS_PER_STEP = 150


def log(*args):
    print(*args, flush=True)


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


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def device_profile(fn, reps, top=6):
    """``torch.profiler`` over ``reps`` calls after a warm-up: the wall time
    a call (with the profiler's overhead), the device time a call summed
    over kernels and copies, and the kernels with the most device time
    (ms a call)."""
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
        top={e.key[:60]: e.self_device_time_total / 1e3 / reps for e in rows[:top]},
    )


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; this check needs an NVIDIA GPU")
    from volym_tpu_torch import Camera, RenderParams, Scene, cli, parity
    from volym_tpu_torch.ops import _build, slab_march, slab_replay
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
    with ThreadPoolExecutor(len(KERNELS)) as pool:
        builds = dict(zip(KERNELS, pool.map(_build.build, KERNELS)))
    for name, built in builds.items():
        regs = [int(m) for m in re.findall(r"Used (\d+) registers", built.log)]
        spills = sum(int(m) for m in re.findall(r"(\d+) bytes spill", built.log))
        log(f"build: {built.path.name} for sm_90a in {built.seconds:.1f} s; ptxas: {len(regs)} kernels, "
            f"{min(regs, default=0)}-{max(regs, default=0)} registers, {spills} bytes of spill stores and loads")

    # phase 3: kernels vs plain versions, small
    err = {"slab_march": 0.0, "slab_replay": 0.0}  # the largest absolute error
    rel = {"slab_march": 0.0, "slab_replay": 0.0}  # the largest error over the scale it is held to

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

    worst_edge, n_march, n_emit, n_replay = 0.0, 0, 0, 0
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
    log(f"small: march with residual == plain bit for bit in {n_emit}/48 cases")
    log(f"small: replay == plain in {n_replay}/96 cases, stored and re-sampled "
        f"(max abs err {err['slab_replay']:.3e}, max err over its scale {rel['slab_replay']:.3e}); "
        f"the two routes agree in all {n_emit}")
    if (n_march, n_emit, n_replay) != (48, 48, 96):
        raise AssertionError(f"{n_march}, {n_emit}, {n_replay} small cases ran, expected 48, 48, 96")

    # phase 4: serving at full size
    t0 = time.perf_counter()
    scene = Scene.synthetic("bonsai", side=FULL_SIDE, seed=0, device=dev)
    log(f"scene: {FULL_SIDE}^3 synthetic bonsai made in {time.perf_counter() - t0:.1f} s")
    configs = {
        "bench": RenderParams(
            interpolation="trilinear", density_threshold=0.15, raymarching_step_size=0.005,
            use_shading=False, use_gaussian_smoothing=False, u8_volume=True,
        ),
        "cli_default": RenderParams(
            interpolation="nearest", density_threshold=0.12, raymarching_step_size=0.01,
            use_shading=True, use_gaussian_smoothing=False, u8_volume=True,
        ),
    }
    renderers = {
        name: make_renderer(scene, p, FULL_H, FULL_W, backend="slab_cuda", device=dev) for name, p in configs.items()
    }
    cams = {}
    frames = {}
    per_config = {}
    slab_march.LAUNCHES = slab_replay.LAUNCHES = 0  # the serving path starts here
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

        feats, vol, lut, sign, grad, u8 = slab_march.prepare(scene, cm0, p, FULL_H, FULL_W)
        march_ms = cuda_ms(lambda: slab_march.march_cuda(feats, vol, lut, sign, p, grad, u8=u8), 20)
        plain_march_ms = cuda_ms(lambda: slab.march_slabs(feats, vol, lut, sign, p, grad, u8=u8), 3)
        frame_ms = cuda_ms(lambda: renderers[name](cm0), 10)
        plain_frame_ms = cuda_ms(lambda: slab_march.render(scene, cm0, p, FULL_H, FULL_W, march_fn=slab.march_slabs), 3)
        rays = FULL_H * FULL_W
        # composited steps of this frame, for the operations bound
        _, dens = slab.march_slabs(feats, vol, lut, sign, p, grad, u8, emit_density=True)
        threshold = slab.march_knobs(p, u8)[0]
        composited = int((dens.reshape(vol.shape[0], -1, rays)[:, 0] >= threshold).sum())
        del dens
        bound_ms, bound_by = bound(nbytes(feats, vol, lut, grad) + rays * 16, composited * MARCH_OPS_PER_STEP)
        results[name] = dict(
            planes=int(vol.shape[0]), u8=u8, march_ms=march_ms, plain_march_ms=plain_march_ms,
            bound_ms=bound_ms, bound_by=bound_by, composited_steps=composited,
            frame_ms=frame_ms, plain_frame_ms=plain_frame_ms,
            rays_per_s=rays / (frame_ms / 1e3), plain_rays_per_s=rays / (plain_frame_ms / 1e3),
            max_abs_err=r.max_abs_err, knife_edge_share=r.edge_frac, hit_share=float(hit.float().mean()),
        )
        log(f"{name}: {json.dumps(results[name])}")

    # phase 5: the training step at full size
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
    for (h, w), (s, cm, render) in trainers.items():
        for i in range(TRAIN_STEPS):
            s.volume.grad = s.tf_lut.grad = None
            img = render(cm)
            img.sum().backward()
            if i == 0:
                step0[(h, w)] = (img.detach().clone(), s.volume.grad.clone(), s.tf_lut.grad.clone())
        torch.cuda.synchronize()
    train_launches = (slab_march.LAUNCHES, slab_replay.LAUNCHES)  # the training path ends here
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
        zero_ms = cuda_ms(lambda: torch.zeros_like(dens), 10)
        replay_ms = cuda_ms(lambda: slab_replay.replay_cuda(feats, vol, lut, sign, train_p, out, g, None, u8, dens), 10)
        replay_resampled_ms = cuda_ms(lambda: slab_replay.replay_cuda(feats, vol, lut, sign, train_p, out, g, None, u8), 10)

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
        # entries: a lower bound), the d_vol and d_lut outputs once
        replay_bound = bound(
            nbytes(feats, lut, out, g) + read * 4 + (vol.numel() + lut.numel()) * 4,
            composited * REPLAY_OPS_PER_STEP,
        )
        training[f"{h}x{w}"] = dict(
            planes=int(vol.shape[0]), stored=stored, residual_mib=dens.numel() * 4 / 2**20,
            fwd_residual_ms=fwd_ms, fwd_bound_ms=fwd_bound[0], fwd_bound_by=fwd_bound[1], zero_fill_ms=zero_ms,
            replay_ms=replay_ms, replay_resampled_ms=replay_resampled_ms, plain_replay_ms=plain_replay_ms,
            replay_bound_ms=replay_bound[0], replay_bound_by=replay_bound[1],
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

    # phase 6: a few descent steps on the f32 stream
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

    # phase 7: the CLI
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp) / "shot.png"
        rc = cli.main(["screenshot", "--no-gaussian", "--output", str(out)])
        data = out.read_bytes() if out.exists() else b""
        if rc != 0 or data[:8] != b"\x89PNG\r\n\x1a\n":
            raise AssertionError(f"CLI screenshot failed (rc {rc}, {len(data)} bytes)")
        log(f"cli: screenshot --no-gaussian wrote a {len(data)}-byte PNG")

    bench, step = results["bench"], training[f"{FULL_H}x{FULL_W}"]
    rows = {
        "slab_march": dict(
            launches=serving_launches + train_launches[0], ms=bench["march_ms"], plain_ms=bench["plain_march_ms"],
            bound_ms=bench["bound_ms"], bound_by=bench["bound_by"],
        ),
        "slab_replay": dict(
            launches=train_launches[1], ms=step["replay_ms"], plain_ms=step["plain_replay_ms"],
            bound_ms=step["replay_bound_ms"], bound_by=step["replay_bound_by"],
        ),
    }
    log(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": KERNELS[name][0], "replaces": KERNELS[name][1],
         "launches": row["launches"], "max_abs_err": err[name], "max_rel_err": rel[name],
         "ms": row["ms"], "plain_ms": row["plain_ms"],
         "bound_ms": row["bound_ms"], "bound_by": row["bound_by"], "library_ms": None}
        for name, row in rows.items()
    ]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
