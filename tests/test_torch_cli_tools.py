"""The port's CLI subcommands ``benchmark`` (and ``--scaling``), ``fit``
(and ``--distributed``), ``view``, ``run --live-sweep`` and ``--profile``
on the CPU, the parser against the JAX package's, the commands once
refused, and the import boundary of the new modules (no jax)."""

import csv
import json
import logging
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from volym_tpu import cli as jcli
from volym_tpu.bench import harness as jharness
from volym_tpu_torch import cli, viewer
from volym_tpu_torch import io as vio
from volym_tpu_torch.render import fast
from volym_tpu_torch.render.renderer import make_renderer

REPO = Path(__file__).resolve().parents[1]
SMALL = ["--device", "cpu", "--side", "16", "--width", "16", "--height", "16"]


def _subcommands(parser):
    (action,) = [a for a in parser._actions if isinstance(a, type(parser._subparsers._group_actions[0]))]
    return action.choices


def _flags(parser):
    return ({s for a in parser._actions for s in a.option_strings},
            [a.dest for a in parser._actions if not a.option_strings])


def test_parser_matches_jax():
    """Every subcommand of the JAX package's CLI, with its flags plus
    ``--device`` (``devtools`` touches no tensor and has none); the same
    positionals and defaults."""
    mine, theirs = _subcommands(cli.build_parser()), _subcommands(jcli.build_parser())
    assert set(mine) == set(theirs)
    for name, sub in mine.items():
        (flags, pos), (jflags, jpos) = _flags(sub), _flags(theirs[name])
        assert pos == jpos, name
        assert flags == jflags | ({"--device"} if name != "devtools" else set()), name
    bench, jbench = mine["benchmark"], theirs["benchmark"]
    for flag in ("--trials", "--seconds", "--sweep-steps", "--scaling", "--step-histogram"):
        (a,) = [x for x in bench._actions if flag in x.option_strings]
        (b,) = [x for x in jbench._actions if flag in x.option_strings]
        assert (a.default, a.nargs, a.type) == (b.default, b.nargs, b.type), flag
    assert _flags(cli.build_parser())[0] == _flags(jcli.build_parser())[0]


def _rows(path):
    with open(path, newline="") as f:
        reader = csv.DictReader(f)
        return reader.fieldnames, list(reader)


def test_cli_benchmark_writes_the_sweep(tmp_path, caplog):
    out = tmp_path / "sweep.csv"
    with caplog.at_level(logging.INFO, logger="volym_tpu_torch"):
        rc = cli.main(["benchmark", *SMALL, "--renderer", "slab", "--trials", "1", "--seconds", "0.01",
                       "--sweep-steps", "0.02", "--step-histogram", "--output", str(out)])
    assert rc == 0
    fields, rows = _rows(out)
    assert fields == jharness.CSV_FIELDS + ["rays_per_s"]
    want = [(r["algorithm"], r["step_size"], r["importance_steps"], r["use_cone"]) for r in jharness.benchmark_all(
        lambda p: lambda: None, num_trials=1, seconds=0.0, step_sizes=(0.02,), log=lambda *a: None)]
    assert [(r["algorithm"], float(r["step_size"]), int(r["importance_steps"]), r["use_cone"] == "True")
            for r in rows] == want
    assert all(float(r["rays_per_s"]) > 0 and float(r["avg_total_frames"]) >= 8 for r in rows)
    # the histogram counts every ray of the 16x16 frame
    counted = [int(m.group(1)) for m in (re.search(r": (\d+) rays$", r.getMessage()) for r in caplog.records) if m]
    assert len(counted) == 16 and sum(counted) == 16 * 16


def test_cli_fit_writes_a_checkpoint_and_the_loss_falls(tmp_path, caplog):
    out = tmp_path / "fitted.npz"
    with caplog.at_level(logging.INFO, logger="volym_tpu_torch"):
        rc = cli.main(["fit", *SMALL, "--scene", "sphere", "--frames", "5", "--threshold", "0.05", "--no-gaussian",
                       "--no-shading", "--output", str(out)])
    assert rc == 0
    (first, last), = [tuple(map(float, m.groups())) for r in caplog.records
                      if (m := re.fullmatch(r"loss: (\S+) -> (\S+)", r.getMessage()))]
    assert last < first
    ckpt = vio.load_checkpoint(out)
    assert set(ckpt) == {"volume", "tf_lut"}
    assert ckpt["volume"].shape == (16, 16, 16) and ckpt["tf_lut"].shape == (256, 4)
    assert ckpt["volume"].min() >= 0.0 and ckpt["volume"].max() <= 1.0
    # the fit moved the flat init of max(0.15, threshold + 0.03)
    assert np.abs(ckpt["volume"] - 0.15).max() > 1e-3


def _run_frame(tmp_path, monkeypatch, argv):
    """The frame ``run`` saved (its only screenshot) as uint8 RGBA."""
    from test_torch_entry import read_png

    monkeypatch.chdir(tmp_path)
    assert cli.main(["run", *argv]) == 0
    (png,) = tmp_path.glob("screenshot_*.png")
    img = read_png(png)
    png.unlink()
    return img


def test_cli_run_live_sweep(tmp_path, monkeypatch):
    """``run --renderer ray --live-sweep``: frame i renders through
    ``fast.render`` with threshold 0.05 + 0.2 (i % 10)/10 and the step times
    1 + 0.5 (i % 7)/7; the last of 3 frames is frame 2's.  With another
    renderer the flag is ignored."""
    argv = ["--device", "cpu", "--side", "16", "--width", "12", "--height", "8", "--frames", "3"]
    got = _run_frame(tmp_path, monkeypatch, ["--renderer", "ray", "--live-sweep", *argv])
    args = cli.build_parser().parse_args(["run", "--renderer", "ray", *argv])
    p = cli._params(args)
    cam = cli._camera(args).orbit(2.0, 0.0, 0.0).orbit(2.0, 0.0, 0.0).orbit(2.0, 0.0, 0.0)
    live = p.replace(density_threshold=0.05 + 0.2 * 2 / 10, raymarching_step_size=p.raymarching_step_size * (
        1.0 + 0.5 * 2 / 7))
    scene = cli._default_scene(args)
    want = fast.render(scene, cam.matrices(), live, 8, 12)
    np.testing.assert_array_equal(got, vio.to_uint8_image(want))
    assert not np.array_equal(got, vio.to_uint8_image(fast.render(scene, cam.matrices(), p, 8, 12)))
    # ignored with the slab renderer
    got = _run_frame(tmp_path, monkeypatch, ["--renderer", "slab", "--live-sweep", *argv])
    slab_p = cli._params(cli.build_parser().parse_args(["run", *argv]))
    want = make_renderer(scene, slab_p, 8, 12, backend="slab", device="cpu")(cam.matrices())
    np.testing.assert_array_equal(got, vio.to_uint8_image(want))


@pytest.mark.parametrize("command", ["run", "benchmark"])
def test_cli_profile_writes_a_trace(tmp_path, monkeypatch, command):
    """``--profile DIR`` writes a Chrome trace of the timed region with the
    CPU's ops (the CUDA activity only on a CUDA device) and the program's
    ``volym.*`` spans."""
    monkeypatch.chdir(tmp_path)
    argv = [command, "--device", "cpu", "--renderer", "slab", "--side", "8", "--width", "8", "--height", "8",
            "--no-gaussian", "--profile", str(tmp_path / "prof")]
    argv += ["--frames", "1", "--step-size", "0.2"] if command == "run" else [
        "--trials", "1", "--seconds", "0.0", "--sweep-steps", "0.2", "--output", str(tmp_path / "b.csv")]
    assert cli.main(argv) == 0
    trace = json.loads((tmp_path / "prof" / "trace.json").read_text())
    names = {e.get("name", "") for e in trace["traceEvents"]}
    assert any(n.startswith("aten::") for n in names)
    assert "volym.render" in names


@pytest.mark.parametrize(
    "argv",
    [["run", "--distributed", "--frames", "2"], ["screenshot", "--distributed"],
     ["fit", "--distributed", "--frames", "2"],
     ["benchmark", "--distributed", "--trials", "1", "--seconds", "0.0", "--sweep-steps", "0.2"],
     ["benchmark", "--scaling", "--trials", "1", "--seconds", "0.0"]],
)
def test_cli_unported_raise(tmp_path, monkeypatch, argv):
    """The commands the port refused (``NotImplementedError``) before it had
    ``volym_tpu_torch.parallel`` run now and write their output;
    ``--distributed`` brings up a gloo world of one on the CPU and takes it
    down with the command."""
    monkeypatch.chdir(tmp_path)
    assert cli.main([*argv, "--device", "cpu", "--renderer", "slab", "--side", "8", "--width", "8", "--height", "8",
                     "--output", str(tmp_path / "out")]) == 0
    assert not dist.is_initialized()
    written = {p.name for p in tmp_path.iterdir()}
    assert written & {"out", "out.npz"} or argv[0] == "run" and any(n.startswith("screenshot_") for n in written)


def test_cli_fit_distributed_writes_a_checkpoint(tmp_path, caplog):
    """``fit --distributed`` on 8x8 rays: ``launch.fit_distributed`` on the
    one-process mesh, the loss falls, the coordinator writes."""
    out = tmp_path / "fitted.npz"
    with caplog.at_level(logging.INFO, logger="volym_tpu_torch"):
        rc = cli.main(["fit", "--distributed", *SMALL, "--renderer", "slab", "--scene", "sphere", "--frames", "5",
                       "--threshold", "0.05", "--no-gaussian", "--no-shading", "--output", str(out)])
    assert rc == 0 and not dist.is_initialized()
    (first, last), = [tuple(map(float, m.groups())) for r in caplog.records
                      if (m := re.fullmatch(r"loss: (\S+) -> (\S+)", r.getMessage()))]
    assert last < first
    assert vio.load_checkpoint(out)["volume"].shape == (16, 16, 16)


def test_cli_benchmark_scaling_writes_the_table(tmp_path):
    """``benchmark --scaling``: the JAX package's scaling rows and CSV
    columns, over this process's one device."""
    out = tmp_path / "scaling.csv"
    assert cli.main(["benchmark", "--scaling", *SMALL, "--renderer", "slab", "--trials", "2", "--seconds", "0.01",
                     "--output", str(out)]) == 0
    fields, rows = _rows(out)
    assert fields == jharness.CSV_FIELDS + ["devices", "rays_per_s", "scaling_efficiency"]
    assert set(jharness.SCALING_CSV_FIELDS) <= set(fields)
    (row,) = rows
    assert row["devices"] == "1" and float(row["scaling_efficiency"]) == 1.0 and float(row["rays_per_s"]) > 0


def test_cli_view_parser_and_serve(monkeypatch):
    """``view`` takes the JAX package's ``--host``, ``--port`` and
    ``--screenshot-dir`` and serves the render flags on ``--device``."""
    seen = {}
    monkeypatch.setattr(viewer, "serve", lambda *a, **kw: seen.update(args=a, kwargs=kw) or 0)
    argv = ["view", *SMALL, "--renderer", "ray", "--port", "0", "--host", "0.0.0.0", "--screenshot-dir", "shots"]
    assert cli.main(argv) == 0
    scene, params, height, width = seen["args"]
    assert (height, width, scene.volume.shape) == (16, 16, (16, 16, 16))
    assert params == cli._params(cli.build_parser().parse_args(argv))
    assert seen["kwargs"] == dict(host="0.0.0.0", port=0, screenshot_dir="shots", backend="ray",
                                  device=torch.device("cpu"))
    mine, theirs = cli.build_parser().parse_args(["view"]), jcli.build_parser().parse_args(["view"])
    assert (mine.host, mine.port, mine.screenshot_dir) == (theirs.host, theirs.port, theirs.screenshot_dir)


@pytest.mark.parametrize("command", ["fit", "benchmark", "run"])
def test_cli_cuda_device_without_cuda_raises(tmp_path, monkeypatch, command):
    """The default ``--device cuda`` where CUDA is missing fails; nothing
    renders on the CPU instead (CUDA patched away, so this runs anywhere)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    extra = ["--live-sweep", "--renderer", "ray"] if command == "run" else []
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main([command, "--side", "8", "--width", "8", "--height", "8", *extra])
    assert not list(tmp_path.iterdir())


def test_new_modules_never_import_jax():
    code = (
        "import sys, volym_tpu_torch.bench.harness, volym_tpu_torch.optim, volym_tpu_torch.devtools, "
        "volym_tpu_torch.io, volym_tpu_torch.cli, volym_tpu_torch.viewer, volym_tpu_torch.parallel.launch, "
        "volym_tpu_torch.parallel.mesh\n"
        "volym_tpu_torch.cli.build_parser().parse_args(['benchmark'])\n"
        "assert 'jax' not in sys.modules and not any(m.startswith('volym_tpu.') or m == 'volym_tpu' "
        "for m in sys.modules), sorted(m for m in sys.modules if 'jax' in m or m.startswith('volym_tpu.'))\n"
        "print('ok')"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=300,
                       env={"PATH": "/usr/bin:/bin", "PYTHONPATH": str(REPO)})
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr
