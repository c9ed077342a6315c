"""Command-line entry point of the PyTorch port.

    python -m volym_tpu_torch run [simple]   render an orbit sweep, log FPS, save PNG
    python -m volym_tpu_torch screenshot     single frame -> PNG

The flags are those of ``python -m volym_tpu``, plus ``--device``.  The
default renderer is the CUDA march kernel (``--renderer slab_cuda`` on
``--device cuda``); ``--renderer slab`` runs the plain PyTorch march on any
device.  ``--importance`` gates the march on importance look-ahead along
the ray, ``--importance --cone`` along 8 cone directions (the CUDA gate
kernels with ``slab_cuda``); ``--scene teapot`` is the segmented stand-in
whose lobster is important.  ``--gaussian`` (Gaussian-smoothed density
along the ray) is on by default as in the reference; ``--no-gaussian``
turns it off.  ``--first-hit``, ``--coloring``, ``--distributed`` and
``--profile`` are not ported yet and raise ``NotImplementedError``.
"""

from __future__ import annotations

import argparse
import logging
import sys
import time

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


def _renderer(args):
    from volym_tpu_torch.render.renderer import make_renderer

    for flag in ("distributed", "profile"):
        if getattr(args, flag):
            raise NotImplementedError(f"--{flag} is not ported to volym_tpu_torch yet")
    return make_renderer(
        _default_scene(args), _params(args), args.height, args.width,
        backend=args.renderer, device=args.device,
    )


def _sync(img) -> None:
    if img.device.type == "cuda":
        import torch

        torch.cuda.synchronize(img.device)


def cmd_run(args) -> int:
    """Render ``--frames`` frames along an orbit sweep (2 degrees a frame),
    log FPS once a second, save the last frame."""
    from volym_tpu_torch import io as vio

    render = _renderer(args)
    cam = _camera(args)
    frames, t_last, n_last = 0, time.perf_counter(), 0
    img = None
    for _ in range(args.frames):
        cam = cam.orbit(2.0, 0.0, 0.0)
        img = render(cam.matrices())
        _sync(img)
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

    img = _renderer(args)(_camera(args).matrices())
    out = args.output or f"screenshot_{int(time.time())}.png"
    vio.write_png(out, img)
    log.info("saved %s", out)
    return 0


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
            help="first-hit-then-break instead of alpha compositing (not ported yet)",
        )
        p.add_argument(
            "--importance", action="store_true",
            help="importance look-ahead: skip samples with important material ahead",
        )
        p.add_argument("--cone", action="store_true", help="with --importance: probe 8 cone directions")
        p.add_argument("--coloring", action="store_true", help="importance coloring (not ported yet)")
        p.add_argument(
            "--no-u8", action="store_true",
            help="march the float32 volume (default: the uint8 volume in the "
            "0..255 density domain where the plane count is native)",
        )
        p.add_argument("--ahead-steps", type=int, default=12)
        p.add_argument("--interpolation", default="nearest", choices=["nearest", "trilinear"])
        p.add_argument(
            "--renderer", default="slab_cuda", choices=["slab", "slab_cuda"],
            help="slab_cuda = the CUDA march kernel; slab = the plain PyTorch march",
        )
        p.add_argument("--device", default="cuda", help="torch device to render on")
        p.add_argument("--frames", type=int, default=100)
        p.add_argument("--output")
        p.add_argument("--distributed", action="store_true", help="multi-host run (not ported yet)")
        p.add_argument("--profile", metavar="DIR", help="profiler trace (not ported yet)")

    p_run = sub.add_parser("run", help="orbit-sweep render loop")
    p_run.add_argument("demo", nargs="?", default="simple", choices=["simple"])
    common(p_run)
    p_shot = sub.add_parser("screenshot", help="single frame -> PNG")
    common(p_shot)
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.command is None:
        # reference default: `volym` == `volym run simple`
        args = build_parser().parse_args(["run", *(argv or [])])
    _setup_logging(args.debug)
    return {"run": cmd_run, "screenshot": cmd_screenshot}[args.command](args)


if __name__ == "__main__":
    raise SystemExit(main())
