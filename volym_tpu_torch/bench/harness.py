"""Benchmark harness: the reference protocol, plus rays/s and scaling.

Counterpart of :mod:`volym_tpu.bench.harness`.  It replicates the
reference's sweep exactly (``src/main.rs:178-345``): base parameters from
the benchmark preset (``src/main.rs:180-190``), step sizes {0.003, 0.005,
0.010, 0.020}, look-ahead steps {10, 15, 20}, algorithms {Base, Importance,
ImportanceCone}, 3 trials x 2 s each, mean/stddev stats
(``TrialResults::calculate_stats``, ``src/main.rs:111-175``) and the same
CSV schema (``BenchmarkResult``, ``src/main.rs:71-85``), with rays/s
(frames x H x W / s) appended.

A frame function returns its output while the device may still be working
on it; :func:`force_sync` fences it.  :func:`marginal_time` reads a frame
on the host's clock: what a loop that renders frame after frame pays.  The
device's time by kernel and its idle share are the benchmark's
(``perfbench/trace.py``).
"""

from __future__ import annotations

import csv
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from volym_tpu_torch.config import BENCHMARK_PARAMS, RenderParams

#: Reference sweep constants (src/main.rs:179,192-193; :66 secs; :357 window).
NUM_TRIALS = 3
SECS_PER_TRIAL = 2.0
STEP_SIZES = (0.0030, 0.0050, 0.0100, 0.0200)
IMPORTANCE_STEPS = (10, 15, 20)
BENCH_WIDTH, BENCH_HEIGHT = 1024, 768


@dataclass
class TrialResults:
    """Accumulates per-trial (frames, seconds) and computes the reference's
    stats tuple (``src/main.rs:87-176``)."""

    total_frames: list[int] = field(default_factory=list)
    total_times_ms: list[float] = field(default_factory=list)
    frame_times_ms: list[float] = field(default_factory=list)
    fps_values: list[float] = field(default_factory=list)

    def add_trial(self, frames: int, seconds: float) -> None:
        self.total_frames.append(frames)
        self.total_times_ms.append(seconds * 1000.0)
        self.frame_times_ms.append(seconds * 1000.0 / frames)
        self.fps_values.append(frames / seconds)

    def stats(self) -> dict:
        def mean(xs):
            return float(np.mean(xs))

        def std(xs):
            return float(np.std(xs))  # population std, like the reference

        return {
            "avg_total_frames": mean(self.total_frames),
            "avg_total_time_ms": mean(self.total_times_ms),
            "avg_frame_time_ms": mean(self.frame_times_ms),
            "avg_fps": mean(self.fps_values),
            "std_dev_total_frames": std(self.total_frames),
            "std_dev_total_time_ms": std(self.total_times_ms),
            "std_dev_frame_time_ms": std(self.frame_times_ms),
            "std_dev_fps": std(self.fps_values),
        }


CSV_FIELDS = [
    "algorithm",
    "step_size",
    "importance_steps",
    "use_cone",
    "avg_total_frames",
    "avg_total_time_ms",
    "avg_frame_time_ms",
    "avg_fps",
    "std_dev_total_frames",
    "std_dev_total_time_ms",
    "std_dev_frame_time_ms",
    "std_dev_fps",
]


def _first_tensor(out):
    """The first tensor of ``out``: itself, or the first found depth-first in
    a tuple, list or dict (a dict's values in key order, as JAX flattens
    one); None if it holds none."""
    if isinstance(out, torch.Tensor):
        return out
    if isinstance(out, dict):
        out = [out[k] for k in sorted(out)]
    if isinstance(out, (tuple, list)):
        for item in out:
            t = _first_tensor(item)
            if t is not None:
                return t
    return None


def force_sync(out) -> float:
    """Fetch one element of ``out``'s first tensor to the host and return it
    as a float: the mark that a frame is complete.  A CUDA tensor's fetch
    waits for the work that wrote it, so a timed region closed by this
    counts every frame it launched as finished.  An output with no tensor
    (e.g. a side-effecting frame function returning None) is a no-op that
    returns 0.0."""
    t = _first_tensor(out)
    if t is None:
        return 0.0
    return float(t.detach().reshape(-1)[0].item())


def marginal_time(fn, *, iters: int = 25, warmup: int = 2) -> float:
    """Steady-state seconds/frame of ``fn``: the MARGINAL cost per call.

    Calls queue asynchronously on the device, so timing a batch of N calls
    with ONE trailing fence (:func:`force_sync`) and differencing two batch
    sizes cancels the fixed cost of the fence and of draining the queue.
    This is what a loop pays per frame when it renders frame after frame
    and reads back only to log or save."""
    def batch(n):
        t0 = time.perf_counter()
        out = None
        for _ in range(n):
            out = fn()
        force_sync(out)
        return time.perf_counter() - t0

    for _ in range(warmup):
        force_sync(fn())
    n1 = max(1, iters // 5)
    if iters == n1:
        return batch(iters) / iters
    # the difference of two batches carries the host's jitter; a single
    # unlucky pair can collapse to ~0.  Sanity-bound each estimate against
    # the per-frame average of the large batch (which includes the fence,
    # so it upper-bounds the marginal time) and retry when the difference
    # is implausibly small.
    uppers = []
    for _ in range(3):
        t1 = batch(n1)
        t2 = batch(iters)
        est = max((t2 - t1) / (iters - n1), 1e-9)
        uppers.append(t2 / iters)
        if est > 0.2 * (t2 / iters):
            return est
    # every retry failed the plausibility bound: report the tightest
    # batch-average UPPER bound instead; it includes one fence over `iters`
    # frames, so it overstates the marginal time by at most fence/iters
    # rather than understating it by an arbitrary factor.
    return min(uppers)


#: frames launched between fences.  Fencing every frame would leave the
#: device idle while the host waits and then launches the next frame;
#: batching keeps the queue full, as the reference's presenting loop does
#: (it never reads a frame back, src/event_loop.rs:130).
DISPATCH_BATCH = 8


def run_trial(frame_fn, seconds: float = SECS_PER_TRIAL, warmup: int = 1,
              batch: int = DISPATCH_BATCH):
    """Call ``frame_fn`` repeatedly for ``seconds`` with a fence
    (:func:`force_sync`) every ``batch`` frames and at the end; returns
    (frames, elapsed) with every counted frame device-complete.  The
    analog of the reference's 2-second winit loop with a stop timer
    (``src/main.rs:347-384``); ``frame_fn`` returns the (possibly still
    in-flight) frame output."""
    force_sync(frame_fn())
    for _ in range(warmup - 1):
        frame_fn()
    frames = 0
    out = None
    start = time.perf_counter()
    while True:
        out = frame_fn()
        frames += 1
        if frames % batch == 0:
            force_sync(out)
            if time.perf_counter() - start >= seconds:
                return frames, time.perf_counter() - start


def bench_config(
    render,  # (params) -> frame callable
    params: RenderParams,
    *,
    num_trials: int = NUM_TRIALS,
    seconds: float = SECS_PER_TRIAL,
) -> TrialResults:
    results = TrialResults()
    frame = render(params)
    for _ in range(num_trials):
        frames, dur = run_trial(frame, seconds=seconds)
        results.add_trial(frames, dur)
    return results


def benchmark_all(
    render,
    *,
    base_params: RenderParams = BENCHMARK_PARAMS,
    step_sizes=STEP_SIZES,
    importance_steps=IMPORTANCE_STEPS,
    num_trials: int = NUM_TRIALS,
    seconds: float = SECS_PER_TRIAL,
    height: int = BENCH_HEIGHT,
    width: int = BENCH_WIDTH,
    log=print,
) -> list[dict]:
    """The full reference sweep (``benchmark_all``, src/main.rs:178-345).

    ``render`` maps a RenderParams to a zero-arg frame function.  Returns
    CSV-schema rows, with rays/s appended.
    """
    rows = []

    def run(algorithm: str, params: RenderParams, imp_steps: int, use_cone: bool):
        log(f"benchmark {algorithm} step={params.raymarching_step_size} ahead={imp_steps}")
        tr = bench_config(render, params, num_trials=num_trials, seconds=seconds)
        stats = tr.stats()
        rows.append(
            {
                "algorithm": algorithm,
                "step_size": params.raymarching_step_size,
                "importance_steps": imp_steps,
                "use_cone": use_cone,
                **stats,
                "rays_per_s": stats["avg_fps"] * height * width,
            }
        )

    for step in step_sizes:
        run("Base", base_params.replace(raymarching_step_size=step), 0, False)
    for step in step_sizes:
        for ahead in importance_steps:
            run(
                "Importance",
                base_params.replace(
                    raymarching_step_size=step,
                    importance_check_ahead_steps=ahead,
                    use_importance_rendering=True,
                ),
                ahead,
                False,
            )
    for step in step_sizes:
        for ahead in importance_steps:
            run(
                "ImportanceCone",
                base_params.replace(
                    raymarching_step_size=step,
                    importance_check_ahead_steps=ahead,
                    use_importance_rendering=True,
                    use_cone_importance_check=True,
                ),
                ahead,
                True,
            )
    return rows


SCALING_CSV_FIELDS = [
    "devices",
    "avg_total_frames",
    "avg_total_time_ms",
    "avg_frame_time_ms",
    "avg_fps",
    "std_dev_total_frames",
    "std_dev_total_time_ms",
    "std_dev_frame_time_ms",
    "std_dev_fps",
    "rays_per_s",
    "scaling_efficiency",
]


def scaling_table(
    scene,
    camera_matrices,
    params: RenderParams,
    height: int,
    width: int,
    *,
    devices=None,
    device_counts=None,
    backend: str = "slab_cuda",
    differentiable: bool = False,
    num_trials: int = NUM_TRIALS,
    seconds: float = SECS_PER_TRIAL,
    log=print,
) -> list[dict]:
    """rays/s against the shard count (``SCALING_CSV_FIELDS``), with
    :class:`TrialResults` stats.

    Renders through the ray-sharded renderer
    (:func:`volym_tpu_torch.parallel.mesh.render_sharded`) on meshes of the
    first n of ``devices`` (default every CUDA device of this process; a
    device listed more than once is a virtual shard) for n in
    ``device_counts`` (default 1, 2, 4, ... up to their number), keeping
    the n that divide ``H W``.  A row's ``devices`` is its mesh's shard
    count and its efficiency ``rays_per_s / (devices x rays/s a shard at
    the first row)``."""
    from volym_tpu_torch.parallel import mesh as pmesh

    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("scaling_table's default devices are the CUDA devices; torch.cuda.is_available() is "
                               "False (pass devices to run elsewhere)")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = list(devices)
    if device_counts is None:
        device_counts = [n for n in (1, 2, 4, 8, 16, 32, 64) if n <= len(devices)]
    device_counts = [n for n in device_counts if (height * width) % n == 0]
    rows = []
    base_per_device = None
    for n in device_counts:
        mesh = pmesh.make_mesh(devices[:n])

        def frame():
            return pmesh.render_sharded(
                scene, camera_matrices, params, height, width, mesh,
                differentiable=differentiable, backend=backend,
            )

        tr = TrialResults()
        force_sync(frame())  # the first call outside the timed region
        for _ in range(num_trials):
            frames, dur = run_trial(frame, seconds=seconds)
            tr.add_trial(frames, dur)
        stats = tr.stats()
        rate = stats["avg_fps"] * height * width
        if base_per_device is None:
            base_per_device = rate / mesh.size
        eff = rate / (base_per_device * mesh.size)
        rows.append({"devices": mesh.size, **stats, "rays_per_s": rate, "scaling_efficiency": eff})
        log(
            f"scaling n={mesh.size}: {rate:,.0f} rays/s, efficiency {eff:.2f}, "
            f"fps {stats['avg_fps']:.2f} +- {stats['std_dev_fps']:.2f}"
        )
    return rows


def write_csv(rows: list[dict], path="benchmark_results.csv") -> None:
    """Reference CSV output (``src/main.rs:338-342``) + rays_per_s column."""
    if not rows:
        return
    fields = CSV_FIELDS + [k for k in rows[0] if k not in CSV_FIELDS]
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=fields)
        w.writeheader()
        w.writerows(rows)
