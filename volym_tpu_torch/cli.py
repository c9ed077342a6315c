"""Command-line entry point of the PyTorch port.

    python -m volym_tpu_torch run [simple]   render an orbit sweep, log FPS, save PNG
    python -m volym_tpu_torch benchmark      the reference sweep -> CSV
    python -m volym_tpu_torch screenshot     single frame -> PNG
    python -m volym_tpu_torch view           interactive browser viewer
    python -m volym_tpu_torch fit            inverse-rendering demo -> .npz
    python -m volym_tpu_torch devtools ...   NRRD -> segments.json + raw

The flags are those of ``python -m volym_tpu``, plus ``--device``.  The
default renderer is the CUDA march kernel (``--renderer slab_cuda`` on
``--device cuda``); ``--renderer slab`` runs the plain PyTorch march on any
device; ``--renderer ray`` runs the t-step march of the JAX package's
default renderer (:mod:`volym_tpu_torch.render.fast`) in PyTorch ops on
any device.  ``--importance`` gates the march on importance look-ahead along
the ray, ``--importance --cone`` along 8 cone directions (the CUDA gate
kernels with ``slab_cuda``); ``--scene teapot`` is the segmented stand-in
whose lobster is important.  ``--gaussian`` (Gaussian-smoothed density
along the ray) is on by default as in the reference; ``--no-gaussian``
turns it off.  ``--coloring`` colours by importance (a heat map; it
replaces ``--importance``), ``--first-hit`` takes the colour of the first
sample past the threshold.  ``--profile DIR`` writes a ``torch.profiler``
trace of ``run``'s frames or ``benchmark``'s sweep to ``DIR/trace.json``,
the program's ``volym.*`` spans (:mod:`volym_tpu_torch.tracing`) beside
the aten ops and the kernels;
``run --live-sweep`` with ``--renderer ray`` changes the threshold and the
step size every frame.  ``fit`` renders its target with the golden t-step
march and fits the volume and the LUT through the replay backward;
``fit --distributed`` fits through the ray-sharded train step of
``--renderer`` (:func:`volym_tpu_torch.parallel.launch.fit_distributed`).
``--distributed`` brings up the process group first
(:func:`volym_tpu_torch.parallel.launch.maybe_initialize`: NCCL on a CUDA
``--device``, gloo on the CPU, from the ``VOLYM_*`` or torchrun variables,
else a world of one); only rank 0 writes the checkpoint.  ``benchmark
--scaling`` writes rays/s against the shard count to
scaling_results.csv.  ``view`` serves the viewer
(:mod:`volym_tpu_torch.viewer`) at ``--host``:``--port``.
"""

from __future__ import annotations

import argparse
import contextlib
import logging
import sys
import time
from pathlib import Path

log = logging.getLogger("volym_tpu_torch")


def _setup_logging(debug: bool) -> None:
    logging.basicConfig(
        level=logging.DEBUG if debug else logging.INFO,
        format="%(asctime)s %(levelname).1s %(name)s: %(message)s",
        stream=sys.stderr,
    )


def _default_scene(args):
    from volym_tpu_torch.scene import Scene

    if args.volume:
        return Scene.load(args.volume, args.segments_raw, args.segments_json, side=args.side)
    log.info("no --volume given; using the synthetic %s scene", args.scene)
    return Scene.synthetic(args.scene, side=args.side)


def _camera(args):
    from volym_tpu_torch.camera import Camera

    return Camera(aspect=args.width / args.height, distance=args.distance).orbit(
        args.orbit_h, args.orbit_v, 0.0
    )


def _params(args):
    from volym_tpu_torch.config import RenderParams

    return RenderParams(
        density_threshold=args.threshold,
        raymarching_step_size=args.step_size,
        use_gaussian_smoothing=args.gaussian,
        use_importance_rendering=args.importance,
        use_cone_importance_check=args.cone,
        use_importance_coloring=args.coloring,
        importance_check_ahead_steps=args.ahead_steps,
        interpolation=args.interpolation,
        use_shading=not args.no_shading,
        use_opacity=not args.first_hit,
        # every CLI scene source is u8-origin (raw uint8 files, synthetics)
        u8_volume=not args.no_u8,
    )


def _renderer(args, scene, params):
    from volym_tpu_torch.render.renderer import make_renderer

    return make_renderer(scene, params, args.height, args.width, backend=args.renderer, device=args.device)


def _device(args):
    """``--device`` as a torch device; a CUDA device without CUDA raises
    (no fallback to the CPU)."""
    import torch

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device} needs CUDA, and torch.cuda.is_available() is False")
    return device


@contextlib.contextmanager
def _maybe_profile(args):
    """A ``torch.profiler`` trace of the region (CPU activity with the
    program's ``volym.*`` spans, and CUDA activity on a CUDA device) into
    ``--profile DIR``/trace.json."""
    if not args.profile:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if _device(args).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
    path = Path(args.profile) / "trace.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(path))
    log.info("wrote profiler trace to %s", path)


def cmd_run(args) -> int:
    """Render ``--frames`` frames along an orbit sweep (2 degrees a frame),
    log FPS once a second, save the last frame.  With ``--live-sweep`` and
    ``--renderer ray``, frame i renders through ``fast.render`` with the
    threshold and the step size changed (the GUI panel's analog)."""
    from volym_tpu_torch import io as vio
    from volym_tpu_torch.bench.harness import force_sync

    scene = _default_scene(args)
    params = _params(args)
    live = args.live_sweep and args.renderer == "ray"
    if live:
        from volym_tpu_torch.render import fast

        device = _device(args)
        scene = scene.to(device)
    else:
        render = _renderer(args, scene, params)
    cam = _camera(args)
    frames, t_last, n_last = 0, time.perf_counter(), 0
    img = None
    with _maybe_profile(args):
        for i in range(args.frames):
            cam = cam.orbit(2.0, 0.0, 0.0)
            if live:
                live_params = params.replace(
                    density_threshold=0.05 + 0.2 * (i % 10) / 10.0,
                    raymarching_step_size=params.raymarching_step_size * (1.0 + 0.5 * (i % 7) / 7.0),
                )
                img = fast.render(scene, cam.matrices(device=device), live_params, args.height, args.width)
            else:
                img = render(cam.matrices())
            force_sync(img)
            frames += 1
            now = time.perf_counter()
            if now - t_last >= 1.0:
                log.info("FPS: %.1f", (frames - n_last) / (now - t_last))
                t_last, n_last = now, frames
    if img is not None:
        log.info("saved %s", vio.save_screenshot(img, "."))
    return 0


def cmd_screenshot(args) -> int:
    from volym_tpu_torch import io as vio

    img = _renderer(args, _default_scene(args), _params(args))(_camera(args).matrices())
    out = args.output or f"screenshot_{int(time.time())}.png"
    vio.write_png(out, img)
    log.info("saved %s", out)
    return 0


def cmd_benchmark(args) -> int:
    """The reference sweep (``harness.benchmark_all``) from the preset
    ``BENCHMARK_PARAMS``: only ``--renderer``, ``--device``, the scene flags
    and ``--width``/``--height`` reach it.  -> ``--output`` or
    benchmark_results.csv.  With ``--scaling``, ``harness.scaling_table``
    of the render flags over this process's devices -> ``--output`` or
    scaling_results.csv."""
    import torch

    from volym_tpu_torch.bench import harness
    from volym_tpu_torch.render.renderer import make_renderer

    scene = _default_scene(args)
    m = _camera(args).matrices()
    if args.scaling:
        # the devices of this process: every card, or the CPU
        device = _device(args)
        devices = ([torch.device("cuda", i) for i in range(torch.cuda.device_count())] if device.type == "cuda"
                   else [device])
        rows = harness.scaling_table(
            scene, m, _params(args), args.height, args.width, devices=devices, backend=args.renderer,
            num_trials=args.trials, seconds=args.seconds, log=log.info,
        )
        out = args.output or "scaling_results.csv"
        harness.write_csv(rows, out)
        log.info("wrote %s (%d rows)", out, len(rows))
        return 0

    def render_factory(params):
        r = make_renderer(scene, params, args.height, args.width, backend=args.renderer, device=args.device)
        # no fence: run_trial fences every DISPATCH_BATCH frames
        return lambda: r(m)

    if args.step_histogram:
        from volym_tpu_torch.render import debug_vis

        device = _device(args)
        edges, hist = debug_vis.step_count_histogram(
            scene.to(device), m.to(device), _params(args).replace(adaptive_stepping=True),
            args.height, args.width,
        )
        for lo, hi, n in zip(edges[:-1], edges[1:], hist):
            log.info("steps %4d-%4d: %d rays", int(lo), int(hi), int(n))

    with _maybe_profile(args):
        rows = harness.benchmark_all(
            render_factory,
            num_trials=args.trials,
            seconds=args.seconds,
            height=args.height,
            width=args.width,
            step_sizes=tuple(args.sweep_steps) if args.sweep_steps else harness.STEP_SIZES,
            log=log.info,
        )
    out = args.output or "benchmark_results.csv"
    harness.write_csv(rows, out)
    log.info("wrote %s (%d rows)", out, len(rows))
    return 0


def cmd_fit(args) -> int:
    """Fit the volume and the LUT, from a flat volume, to the golden render
    of the scene: ``--frames`` Adam steps, the loss logged every 10;
    ``volume`` and ``tf_lut`` -> ``--output`` or fitted_scene.npz.  With
    ``--distributed`` the steps are ``launch.fit_distributed``'s on the
    ``--renderer`` backend, and only the coordinator writes."""
    import torch

    from volym_tpu_torch import io as vio
    from volym_tpu_torch.optim import fit_scene
    from volym_tpu_torch.render import golden
    from volym_tpu_torch.scene import Scene

    device = _device(args)
    target_scene = _default_scene(args).to(device)
    cm = _camera(args).matrices(device=device)
    # a scene-only fit on the f32 volume: a fitted volume leaves the u8 grid
    # on the first step
    params = _params(args).replace(adaptive_stepping=False, camera_grads=False, u8_volume=False)
    target = golden.render(target_scene, cm, params, args.height, args.width)
    # the init must clear the density threshold, or the renderer masks every
    # sample and the fit has exactly-zero gradients (a flat loss)
    init = Scene(
        volume=torch.full_like(target_scene.volume, max(0.15, params.density_threshold + 0.03)),
        importance=target_scene.importance,
        tf_lut=target_scene.tf_lut,
    )

    def cb(i, loss):
        if i % 10 == 0:
            log.info("fit step %d loss %.6f", i, loss)

    if args.distributed:
        from volym_tpu_torch.parallel import launch

        fitted, losses = launch.fit_distributed(init, cm, target, params, steps=args.frames, backend=args.renderer,
                                                callback=cb)
        writes = launch.is_coordinator()
    else:
        res = fit_scene(init, cm, target, params, steps=args.frames, callback=cb)
        fitted, losses, writes = res.scene, res.losses, True
    log.info("loss: %.6f -> %.6f", losses[0], losses[-1])
    if writes:
        vio.save_checkpoint(args.output or "fitted_scene.npz", {"volume": fitted.volume, "tf_lut": fitted.tf_lut})
    return 0


def cmd_view(args) -> int:
    """The interactive viewer (:mod:`volym_tpu_torch.viewer`): a browser
    page whose drags, wheel and panel drive renders with ``--renderer`` on
    ``--device``."""
    from volym_tpu_torch import viewer

    device = _device(args)
    return viewer.serve(_default_scene(args), _params(args), args.height, args.width, host=args.host,
                        port=args.port, screenshot_dir=args.screenshot_dir, backend=args.renderer, device=device)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="volym_tpu_torch")
    ap.add_argument("--debug", action="store_true", help="enable debug logging")
    sub = ap.add_subparsers(dest="command")

    def common(p):
        p.add_argument(
            "--debug", action="store_true", default=argparse.SUPPRESS,
            help="enable debug logging",
        )
        p.add_argument("--volume", help="raw uint8 volume path")
        p.add_argument("--segments-raw", help="segments.raw path")
        p.add_argument("--segments-json", help="segments.json path")
        p.add_argument("--scene", default="bonsai", choices=["bonsai", "sphere", "teapot"])
        p.add_argument("--side", type=int, default=256)
        p.add_argument("--width", type=int, default=1024)
        p.add_argument("--height", type=int, default=768)
        p.add_argument("--distance", type=float, default=1.0)
        p.add_argument("--orbit-h", type=float, default=0.0)
        p.add_argument("--orbit-v", type=float, default=0.0)
        p.add_argument("--threshold", type=float, default=0.12)
        p.add_argument("--step-size", type=float, default=0.01)
        p.add_argument(
            "--gaussian", action=argparse.BooleanOptionalAction, default=True,
            help="Gaussian-smoothed sampling (reference default ON)",
        )
        p.add_argument("--no-shading", action="store_true", help="disable Blinn-Phong shading")
        p.add_argument(
            "--first-hit", action="store_true",
            help="first-hit-then-break instead of alpha compositing",
        )
        p.add_argument(
            "--importance", action="store_true",
            help="importance look-ahead: skip samples with important material ahead",
        )
        p.add_argument("--cone", action="store_true", help="with --importance: probe 8 cone directions")
        p.add_argument("--coloring", action="store_true", help="importance coloring: a heat map of the importance grid")
        p.add_argument(
            "--no-u8", action="store_true",
            help="march the float32 volume (default: the uint8 volume in the "
            "0..255 density domain where the plane count is native)",
        )
        p.add_argument("--ahead-steps", type=int, default=12)
        p.add_argument("--interpolation", default="nearest", choices=["nearest", "trilinear"])
        p.add_argument(
            "--renderer", default="slab_cuda", choices=["slab", "slab_cuda", "ray"],
            help="slab_cuda = the CUDA march kernel; slab = the plain PyTorch march; "
            "ray = the t-step march (early exit) in PyTorch ops",
        )
        p.add_argument("--device", default="cuda", help="torch device to render on")
        p.add_argument("--frames", type=int, default=100)
        p.add_argument("--output")
        p.add_argument(
            "--distributed", action="store_true",
            help="bring up the process group from the VOLYM_* or torchrun env vars (see "
            "volym_tpu_torch/parallel/launch.py); fit trains on the ray-sharded step",
        )
        p.add_argument(
            "--profile", metavar="DIR",
            help="write a torch.profiler trace of run's frames or benchmark's sweep to DIR/trace.json: the "
            "program's volym.* spans beside the aten ops and the kernels",
        )

    p_run = sub.add_parser("run", help="orbit-sweep render loop")
    p_run.add_argument("demo", nargs="?", default="simple", choices=["simple"])
    common(p_run)
    p_run.add_argument(
        "--live-sweep", action="store_true",
        help="with --renderer ray: change the threshold and the step size every frame",
    )
    p_bench = sub.add_parser("benchmark", help="full reference sweep -> CSV")
    common(p_bench)
    p_bench.add_argument("--trials", type=int, default=3)
    p_bench.add_argument("--seconds", type=float, default=2.0)
    p_bench.add_argument("--sweep-steps", type=float, nargs="*")
    p_bench.add_argument(
        "--scaling", action="store_true",
        help="rays/s vs device count table instead of the parameter sweep",
    )
    p_bench.add_argument(
        "--step-histogram", action="store_true",
        help="log the per-ray march-length histogram before the sweep",
    )
    p_shot = sub.add_parser("screenshot", help="single frame -> PNG")
    common(p_shot)
    p_view = sub.add_parser("view", help="interactive browser viewer (live orbit + panel)")
    common(p_view)
    p_view.add_argument("--host", default="127.0.0.1")
    p_view.add_argument("--port", type=int, default=8000)
    p_view.add_argument("--screenshot-dir", default=".")
    p_fit = sub.add_parser("fit", help="inverse-rendering demo")
    common(p_fit)
    p_dev = sub.add_parser("devtools", help="NRRD -> segments.json + raw")
    p_dev.add_argument("input")
    p_dev.add_argument("json_out")
    p_dev.add_argument("raw_out")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.command is None:
        # reference default: `volym` == `volym run simple`
        args = build_parser().parse_args(["run", *(argv or [])])
    _setup_logging(args.debug)
    # the process group comes up before any other device use, and goes down
    # with the command that brought it up
    from volym_tpu_torch.parallel import launch

    started = launch.maybe_initialize(getattr(args, "distributed", False), device=getattr(args, "device", "cuda"))
    try:
        if args.command == "devtools":
            from volym_tpu_torch import devtools

            devtools.convert(args.input, args.json_out, args.raw_out)
            return 0
        cmd = {"run": cmd_run, "benchmark": cmd_benchmark, "screenshot": cmd_screenshot, "fit": cmd_fit,
               "view": cmd_view}
        return cmd[args.command](args)
    finally:
        if started:
            import torch.distributed as dist

            dist.destroy_process_group()


if __name__ == "__main__":
    raise SystemExit(main())
