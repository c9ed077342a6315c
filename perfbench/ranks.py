"""One fitting job over one process per card: the ``fit_ranks`` loop.

``run.py``'s process is rank 0.  It starts the ``ranks - 1`` workers at
once, each the same script with a hidden ``--worker`` argument, and each
rank brings up the program's process group through
``parallel.launch.maybe_initialize`` and the ``VOLYM_*`` variables (NCCL,
rank k on card k; gloo on the CPU), as ``fit --distributed`` does.  A second
group, on gloo and CPU tensors, carries the benchmark's own messages, all
outside the window: the check that every rank made the same inputs, the
window's step count, each rank's step count, peak memory and traced window,
its traced device operations, and the replicas' gap.  No message of the
benchmark passes inside the window.

Every rank runs :func:`run_rank` in step with the others, on a slice of the
host's cores of its own.  Rank 0 sizes the window in set-up: as many steps
as ``--seconds`` holds at the pace of its warm-up round, which every rank
then runs; it alone reads the per-layer metrics, judges ``correct`` and
prints the result.  Workers print nothing to standard output.  A worker that exits before the run's last collective ends the run:
rank 0 kills every worker and exits with 3, printing no result, wherever its
own thread waits.  A worker whose parent is gone exits.
"""

from __future__ import annotations

import gc
import importlib
import json
import os
import re
import socket
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

import torch
import torch.distributed as dist

#: how often a rank looks at the processes it depends on (s)
POLL_S = 0.2
#: how long rank 0 waits for its workers to exit after the last collective (s)
JOIN_S = 120.0
#: the script every rank runs
SCRIPT = Path(__file__).resolve().parent / "run.py"


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class Workers:
    """Rank 0's workers, ranks 1 to world - 1: started at once, watched from
    a thread until ``closing`` is set before the last collective, and killed
    if rank 0 leaves the ``with`` block by an exception."""

    def __init__(self, argvs: list[list[str]]):
        self.closing = False
        self.procs = [subprocess.Popen(a, stdin=subprocess.DEVNULL, stdout=subprocess.DEVNULL) for a in argvs]
        threading.Thread(target=self._watch, name="perfbench-workers", daemon=True).start()

    def _watch(self):
        while not self.closing:
            for k, p in enumerate(self.procs, 1):
                rc = p.poll()
                if rc is not None and not self.closing:
                    print(f"perfbench: rank {k} exited with {rc} before the run's end; ending every rank",
                          file=sys.stderr, flush=True)
                    self.kill()
                    os._exit(3)
            time.sleep(POLL_S)

    def kill(self):
        for p in self.procs:
            if p.poll() is None:
                p.kill()
        for p in self.procs:
            p.wait()

    def join(self) -> list[int | None]:
        """Each worker's exit code; one that has not exited in JOIN_S is
        killed and reads None."""
        self.closing = True
        rcs = []
        for p in self.procs:
            try:
                rcs.append(p.wait(timeout=JOIN_S))
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
                rcs.append(None)
        return rcs

    def __enter__(self):
        return self

    def __exit__(self, kind, value, tb):
        if kind is not None:
            self.closing = True
            self.kill()
        return False


def watch_parent():
    """End this worker when the process that started it is gone."""
    parent = os.getppid()

    def watch():
        while os.getppid() == parent:
            time.sleep(POLL_S)
        os._exit(3)

    threading.Thread(target=watch, name="perfbench-parent", daemon=True).start()


def pin_cores(rank: int, world: int) -> list[int]:
    """Give every thread of this process the ``rank``-th of ``world``
    disjoint slices of the cores it may run on, so that the ranks' host
    threads do not take each other's cores (threads started later inherit
    it); where there are fewer cores than ranks, leave them all.  -> the
    cores."""
    cores = sorted(os.sched_getaffinity(0))
    if world == 1 or len(cores) < world:
        return cores
    per = len(cores) // world
    mine = cores[rank * per:(rank + 1) * per]
    for tid in os.listdir("/proc/self/task"):
        try:
            os.sched_setaffinity(int(tid), mine)
        except OSError:  # a thread that ended meanwhile
            pass
    return mine


def window_steps(seconds: float, round_s: list[float]) -> int:
    """The steps that ``seconds`` hold at the median pace of the warm-up
    round's steps."""
    return max(1, round(seconds / statistics.median(round_s)))


def checksums(tensors) -> list[int]:
    """Each tensor's sum of the bit patterns of its entries, exact in int64."""
    out = []
    for t in tensors:
        t = t.detach().contiguous()
        bits = t.view(torch.int32) if t.element_size() == 4 else t.view(torch.uint8)
        out.append(int(bits.sum(dtype=torch.int64)))
    return out


class Control:
    """The benchmark's messages between the ranks, on a gloo group."""

    def __init__(self, timeout):
        self.group = dist.new_group(backend="gloo", timeout=timeout)
        self.world = dist.get_world_size()

    def share(self, value: int) -> int:
        """Rank 0's ``value``, on every rank."""
        t = torch.tensor([int(value)], dtype=torch.int64)
        dist.broadcast(t, src=0, group=self.group)
        return int(t)

    def gather(self, values, dtype=torch.float64) -> torch.Tensor:
        """(world, len(values)): every rank's ``values``, in rank order."""
        mine = torch.tensor(values, dtype=dtype)
        out = [torch.empty_like(mine) for _ in range(self.world)]
        dist.all_gather(out, mine, group=self.group)
        return torch.stack(out)

    def barrier(self):
        dist.barrier(group=self.group)

    def gather_objects(self, obj) -> list:
        """Every rank's ``obj``, in rank order."""
        out = [None] * self.world
        dist.all_gather_object(out, obj, group=self.group)
        return out

    def replica_gap(self, leaves: dict[str, torch.Tensor]) -> float:
        """The largest absolute difference of any entry of any rank's leaves
        from rank 0's (infinite where either side is NaN)."""
        gap = torch.zeros(1, dtype=torch.float64)
        for name in sorted(leaves):
            mine = leaves[name].detach().float().cpu()
            zero = mine.clone()
            dist.broadcast(zero, src=0, group=self.group)
            d = (mine - zero).abs()
            d = torch.where(torch.isnan(d), torch.inf, d)
            gap = torch.maximum(gap, d.max().double().reshape(1))
        dist.all_reduce(gap, op=dist.ReduceOp.MAX, group=self.group)
        return float(gap)


def plant(job, fault: list[str] | None):
    """``fault`` [hook, name] (calibration and tests): call the function
    ``hook`` ("module:function") names with the job and ``name``."""
    if fault is not None:
        module, func = fault[0].split(":")
        getattr(importlib.import_module(module), func)(job, fault[1])


def run_rank(cell, cfg: dict, seed: int, seconds: float, traced: bool, device: str, backend: str, rank: int,
             world: int, coordinator: str, fault: list[str] | None = None, t0: float | None = None,
             workers: Workers | None = None) -> dict:
    """One rank's run, in step with the others: set-up, the window, the
    steps the check needs, the traced segment; then the gathers and the
    replicas' gap.  -> what rank 0 reports (workers: the same, unused)."""
    from perfbench import cells, run, stats
    from perfbench import trace as trace_mod

    pin_cores(rank, world)
    # one intra-op thread a rank, as torchrun sets for several processes a
    # node: the ranks' host threads share one host's cores
    torch.set_num_threads(1)
    job = cells.RanksFitJob(cfg, cell.traffic, seed, device, backend, rank=rank, world=world,
                            coordinator=coordinator)
    ctl = Control(job.timeout)
    sums = ctl.gather(checksums(job.inputs()), dtype=torch.int64)
    if not bool((sums == sums[0]).all()):
        raise RuntimeError(f"the ranks made different inputs from seed {seed}: checksums {sums.tolist()}")
    plant(job, fault)
    job.warm_up()
    on_card = job.device.type == "cuda"
    if on_card:
        torch.cuda.synchronize(job.device)
    ctl.barrier()
    count = ctl.share(window_steps(seconds, job.round_s) if rank == 0 else 0)
    setup_s = time.perf_counter() - t0 if t0 is not None else None

    setup_peak = window_peak = 0
    if on_card:
        setup_peak = torch.cuda.max_memory_allocated(job.device)
        torch.cuda.reset_peak_memory_stats(job.device)
    gc.collect()
    win = stats.run_window(job.issue, job.sync, seconds, keep=job.keep, count=count)
    job.next_index = job.finish(win.count)
    if on_card:
        window_peak = torch.cuda.max_memory_allocated(job.device)

    tr, items, work, busy, peers = None, [], {}, (0.0, 0.0), []
    if traced:
        tr, items, work = run.traced_segment(job, "fit", run.TRACE_ITEMS["fit"])
        ops = []
        if on_card and items:
            lo, hi = items[0][0], items[-1][1]
            busy = (trace_mod.busy_us(tr, lo, hi) / 1e6, (hi - lo) / 1e6)
            ops = [op for op in tr.device if op[2] > lo and op[1] < hi]
        peers = ctl.gather_objects((ops, items))[1:]
    per_rank = ctl.gather([win.count, job.next_index, setup_peak, window_peak, *busy])
    if workers is not None:
        workers.closing = True
    gap = ctl.replica_gap(job.leaves)
    dist.destroy_process_group()
    steps = per_rank[:, :2].long()
    if not bool((steps == steps[0]).all()):
        raise RuntimeError(f"the ranks ran different steps (window, all): {steps.tolist()}")
    return {"job": job, "window": win, "setup_s": setup_s, "window_peak": window_peak, "trace": tr,
            "items": items, "work": work, "per_rank": per_rank, "replica_gap": gap, "peers": peers}


def worker_argv(cell_name: str, seed: int, seconds: float, traced: bool, spec: dict) -> list[str]:
    return [sys.executable, str(SCRIPT), "--workload", cell_name, "--seed", str(seed), "--seconds", repr(seconds),
            "--trace", str(int(traced)), "--worker", json.dumps(spec)]


def worker_main(cell_name: str, seed: int, seconds: float, traced: bool, spec: dict, root: Path) -> None:
    """A worker's run: rank ``spec["rank"]`` of ``spec["world"]``."""
    from perfbench import spec as spec_mod

    watch_parent()
    cell = spec_mod.load_cell(cell_name, root)
    cfg = dict(cell.config, **(spec["overrides"] or {}))
    run_rank(cell, cfg, seed, seconds, traced, spec["device"], spec["backend"], spec["rank"], spec["world"],
             spec["coordinator"], fault=spec["fault"])


def topology_note() -> str:
    """The link between cards 0 and 1 as ``nvidia-smi topo -m`` names it."""
    try:
        out = subprocess.run(["nvidia-smi", "topo", "-m"], capture_output=True, text=True, timeout=20)
    except (OSError, subprocess.TimeoutExpired):
        return "unknown"
    lines = [re.sub(r"\x1b\[[0-9;]*m", "", line).split() for line in out.stdout.splitlines()]
    header = next((line for line in lines if "GPU1" in line), [])
    row = next((line for line in lines if line[:2] == ["GPU0", "X"]), None)
    if row is None or "GPU1" not in header or len(row) <= 1 + header.index("GPU1"):
        return "unknown"
    return row[1 + header.index("GPU1")]


def run_cell(cell, cfg: dict, seed: int, seconds: float, traced: bool, device: str, backend: str, t0: float,
             overrides: dict | None = None, world: int | None = None, fault: list[str] | None = None,
             extra=None) -> tuple[dict, dict]:
    """Rank 0's run of a ``fit_ranks`` cell; -> (the result, notes), as
    ``run.run_cell``.  ``world`` (tests and calibration) replaces the mix's
    ``ranks``, which otherwise must be the cell's ``chips``; ``fault`` is
    planted in every rank (:func:`plant`); ``extra(job)`` adds notes after
    the check (calibration's control)."""
    from perfbench import layers, run

    if world is None:
        world = int(cell.traffic["ranks"])
        if world != cell.chips:
            raise ValueError(f"{cell.name}: the mix's {world} ranks are not the cell's {cell.chips} chips")
    spec = {"world": world, "coordinator": f"127.0.0.1:{free_port()}", "device": device, "backend": backend,
            "overrides": overrides, "fault": fault}
    argvs = [worker_argv(cell.name, seed, seconds, traced, dict(spec, rank=k)) for k in range(1, world)]
    with Workers(argvs) as workers:
        r = run_rank(cell, cfg, seed, seconds, traced, device, backend, 0, world, spec["coordinator"], fault=fault,
                     t0=t0, workers=workers)
        rcs = workers.join()
    if any(rc != 0 for rc in rcs):
        raise RuntimeError(f"workers 1..{world - 1} exited with {rcs}")

    job, win, per_rank = r["job"], r["window"], r["per_rank"]
    on_card = job.device.type == "cuda"
    if traced:
        r0, r1 = job.rows()
        ctx = layers.Context(cfg=dict(cfg, height=r1 - r0), planes=job.planes(), window=win,
                             trace=r["trace"] if on_card else None, items=r["items"], work=r["work"],
                             peak_window_bytes=r["window_peak"], ranks=world, peers=r["peers"])
        metrics, breakdown, device_extra = run.per_layer(cell, ctx)
        if device_extra:  # every rank's traced window, averaged over the cards
            device_extra = {"busy_s": float(per_rank[:, 4].mean()), "window_s": float(per_rank[:, 5].mean())}
        notes = ctx.notes
    else:
        metrics = run.end_to_end(cell, r["setup_s"], win)
        breakdown, device_extra, notes = None, {}, {}

    peak = int(per_rank[:, 2:4].max()) if on_card else 0
    result, notes = run.finish(job, cell, win, metrics, breakdown, device_extra, notes, world, peak,
                               numbers={"replica_gap": r["replica_gap"]})
    notes["rank_steps"] = per_rank[:, 1].long().tolist()
    notes["rank_peak_bytes"] = per_rank[:, 2:4].max(dim=1).values.long().tolist()
    if on_card:
        notes["topology_gpu0_gpu1"] = topology_note()
    if extra is not None:
        notes.update(extra(job))
    return result, notes
