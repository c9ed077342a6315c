"""Run one cell of ``BENCHMARK.json`` once and print its result line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  The run makes its inputs from the seed on
the card, builds the program's renderer, warms up every shape the cell's
traffic uses, measures ``--seconds`` of frames or steps, then compares
what the program produced with the plain reference.  The last line of
standard output is one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with ``--trace
1`` its per-layer metrics), ``device`` (and ``breakdown`` when traced),
and last ``checks``, each compared number beside its limit; standard error
ends with the same numbers and limits.  Without CUDA, or with fewer cards
than the cell asks for, it exits 2 and prints no result; so it does if JAX
or the JAX package is loaded when the result is due.  A cell whose mix runs
one process per card (``fit_ranks``) starts its other ranks as this script
with a hidden ``--worker`` argument (``perfbench/ranks.py``).
"""

from __future__ import annotations

import time

T0 = time.perf_counter()  # the process's start, as near as the script can read it

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

#: top-level modules the run must not load: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "volym_tpu")
#: items traced after the untraced window, and the first of them left out
TRACE_ITEMS = {"view": 48, "fit": 32}
TRACE_SKIP = 4
#: analysed items whose work the reference counts for the rooflines
WORK_ITEMS = 3


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is one of FORBIDDEN, compared
    whole (``volym_tpu_torch`` is not ``volym_tpu``)."""
    return sorted({name.split(".")[0] for name in list(sys.modules) if name.split(".")[0] in FORBIDDEN})


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=20)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else "unknown"
    except (OSError, subprocess.TimeoutExpired):
        return "unknown"


def traced_segment(job, loop: str, n_items: int):
    """Profile ``n_items`` more items (CPU and, on a card, CUDA activity)
    and snapshot the fit's state before the items whose work is counted.
    -> (trace, analysed item spans, {analysed index: counts})."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from perfbench import trace as trace_mod
    from perfbench.traffic import sample_indices

    analysed = list(range(TRACE_SKIP, n_items))
    counted = [analysed[k] for k in sample_indices(job.seed + 7, WORK_ITEMS, len(analysed))]
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if job.device.type == "cuda" else [])
    states = {}
    start = job.next_index
    with profile(activities=activities) as prof:
        for k in range(n_items):
            if loop == "fit" and k in counted:
                states[k] = {n: v.detach().clone() for n, v in job.leaves.items()}
            with record_function(trace_mod.ITEM_SPAN):
                job.sync(job.issue(start + k))
    job.next_index = start + n_items
    tr = trace_mod.from_profiler(prof)
    spans = trace_mod.item_spans(tr)
    items = [spans[k] for k in analysed] if len(spans) == n_items else []
    work = {}
    for k in counted:
        idx = analysed.index(k)
        work[idx] = job.work_counts(start + k) if loop == "view" else job.work_counts(start + k, states[k])
    return tr, items, work


def per_layer(cell, ctx) -> tuple[dict, dict | None, dict]:
    """A traced run's per-layer metrics that found something to read, its
    breakdown and the device's busy and traced seconds (none without a
    device trace)."""
    from perfbench import spec
    from perfbench import trace as trace_mod

    metrics, breakdown, device_extra = {}, None, {}
    for m in cell.per_layer:
        value = spec.load_reader(m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    if ctx.trace is not None and ctx.items:
        lo, hi = ctx.items[0][0], ctx.items[-1][1]
        device_extra = {"busy_s": trace_mod.busy_us(ctx.trace, lo, hi) / 1e6, "window_s": (hi - lo) / 1e6}
        breakdown = {"device_ops": trace_mod.top_device_ops(ctx.trace, lo, hi),
                     "idle_gaps": trace_mod.idle_gaps(ctx.trace, lo, hi)}
    return metrics, breakdown, device_extra


def end_to_end(cell, setup_s: float, win) -> dict:
    e2e = {"setup_s": setup_s, "frame_ms": win.per_item_ms(), "step_ms": win.per_item_ms(),
           "frame_p95_ms": win.p95_ms()}
    return {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]} for m in cell.end_to_end}


def result_line(correct: bool, checks: dict, attempted: int, metrics: dict, dev, count: int, peak: int,
                device_extra: dict, breakdown: dict | None) -> dict:
    """The result object, its keys in the order the line prints them."""
    import torch

    on_card = dev.type == "cuda"
    result = {
        "correct": correct,
        "attempted": attempted,
        "failed": sum(1 for c in checks.values() if c["limit"] is None or not c["value"] <= c["limit"]),
        "metrics": metrics,
        "device": {
            "platform": "gpu" if on_card else dev.type,
            "kind": torch.cuda.get_device_name(dev) if on_card else "cpu",
            "count": count,
            "memory_peak_bytes": int(peak),
            **device_extra,
        },
    }
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    return result


def finish(job, cell, win, metrics: dict, breakdown: dict | None, device_extra: dict, notes: dict, count: int,
           peak: int, numbers: dict | None = None) -> tuple[dict, dict]:
    """The end of a run, once its window and traced segment are over: the
    program's state freed, what it produced compared with the reference
    (``numbers`` joins the job's own), the result object and the notes: the
    mean latency of each tenth of the window, the reference's step counts
    where the job records them, the card's power limit."""
    import torch

    from perfbench import check, stats

    on_card = job.device.type == "cuda"
    job.release()
    if on_card:
        torch.cuda.empty_cache()
    got = job.numbers()
    got.update(numbers or {})
    correct, checks = check.judge(got, cell.limits)
    result = result_line(correct, checks, win.count, metrics, job.device, count, peak, device_extra, breakdown)
    notes["window_tenths_ms"] = stats.tenths_ms(win.latencies)
    notes.update(getattr(job, "work_notes", {}))
    notes["power_limit"] = power_limit() if on_card else "none"
    return result, notes


def run_cell(name: str, seed: int, seconds: float, traced: bool, device: str = "cuda", backend: str = "slab_cuda",
             overrides: dict | None = None, root: Path = ROOT, t0: float | None = None) -> tuple[dict, dict]:
    """One run of the cell ``name``; -> (the result object, notes for
    standard error: each roofline's bounding rate and what :func:`finish`
    adds).  ``overrides`` (tests on the CPU) replaces entries of the
    configuration.  A ``fit_ranks`` cell runs through ``ranks.run_cell``."""
    import torch

    from perfbench import cells, layers, spec, stats

    t0 = T0 if t0 is None else t0
    cell = spec.load_cell(name, root)
    cfg = dict(cell.config, **(overrides or {}))
    loop = cell.traffic["loop"]
    if loop == "fit_ranks":
        from perfbench import ranks

        return ranks.run_cell(cell, cfg, seed, seconds, traced, device, backend, t0, overrides=overrides)
    job = cells.JOBS[loop](cfg, cell.traffic, seed, device, backend)
    job.warm_up()
    dev = job.device
    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.synchronize(dev)
    setup_s = time.perf_counter() - t0

    if on_card:
        setup_peak = torch.cuda.max_memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    gc.collect()
    win = stats.run_window(job.issue, job.sync, seconds, keep=job.keep)
    job.next_index = job.finish(win.count)
    window_peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
    peak = max(setup_peak, window_peak) if on_card else 0

    result_metrics, breakdown, device_extra = {}, None, {}
    if traced:
        tr, items, work = traced_segment(job, loop, TRACE_ITEMS[loop])
        ctx = layers.Context(cfg=cfg, planes=job.planes(), window=win, trace=tr if on_card else None,
                             items=items, work=work, peak_window_bytes=window_peak)
        result_metrics, breakdown, device_extra = per_layer(cell, ctx)
        notes = ctx.notes
    else:
        result_metrics = end_to_end(cell, setup_s, win)
        notes = {}
    return finish(job, cell, win, result_metrics, breakdown, device_extra, notes, cell.chips, peak)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--worker", help=argparse.SUPPRESS)  # a fit_ranks cell's rank > 0, from rank 0
    args = ap.parse_args(argv)
    os.environ.setdefault("USE_FLAX", "0")

    import torch

    from perfbench import spec

    if args.worker is not None:
        from perfbench import ranks

        ranks.worker_main(args.workload, args.seed, args.seconds, bool(args.trace), json.loads(args.worker), ROOT)
        found = forbidden_modules()
        if found:
            print(f"perfbench: a worker loaded {', '.join(found)}: JAX or the JAX package", file=sys.stderr)
            return 2
        return 0

    try:
        cell = spec.load_cell(args.workload, ROOT)
    except (FileNotFoundError, KeyError) as e:
        print(f"perfbench: {e}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"perfbench: the cell needs {cell.chips} CUDA device(s); torch.cuda.is_available() is "
              f"{torch.cuda.is_available()}, {torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    try:
        result, notes = run_cell(args.workload, args.seed, args.seconds, bool(args.trace))
    except ModuleNotFoundError as e:
        print(f"perfbench: {e}: run from the root of a checkout of the repository", file=sys.stderr)
        return 2
    found = forbidden_modules()  # last: whatever the window, the reference or the look at the card loaded
    if found:
        print(f"perfbench: the run loaded {', '.join(found)}: JAX or the JAX package", file=sys.stderr)
        return 2
    for k, v in notes.items():
        print(f"note {k} {v}", file=sys.stderr)
    for k, c in result["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
