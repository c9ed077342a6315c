"""The readings that the limits of ``correct`` are set from (not run by the
benchmark's own runs).

    python3 perfbench/calibrate.py --workload <cell> --seeds <n> [<n> ...] [--faults <n> ...] --out <file>

For each seed, in one process: the cell's set-up, a short window, and the
numbers ``correct`` compares, for the program (the lower reading), for the
control, the plain reference computed in bfloat16 in the program's place
(the upper reading), and, on the ``--faults`` seeds, for the program with
a fault planted in its timed path:

- ``stale``: a frame returns the previous frame (a step that returns its
  state unchanged; for a training job, its optimizer skips the update,
  which reads 1 by the change's measure);
- ``half``: half of the frame's rays left out (for a training job, the
  loss's mean taken over half of the image);
- ``altered``: one entry of the frame altered where it is produced (for a
  training job, of the frame the loss reads).

A training job also reports each step's losses, the first step's frame
against the reference's, and two witnesses of how far rounding alone moves
the later steps: the reference with ``torch.optim.Adam`` in place of its
own Adam, and the reference in blocks of 128 image rows in place of 256
(its gradients' atomics add in another order).

A job over one process per card (``fit_ranks``) runs as the benchmark runs
it, each seed a run of every rank, with ``--ranks`` in place of the mix's
count where given, and its faults planted in every rank
(:func:`plant_rank_fault`): ``skip`` (the last rank leaves the exchange
of the volume's gradient out and steps on its own rows' gradient),
``half`` (the upper half of the ranks leave their rows out, the mean taken
over the rest) and ``altered`` (one entry of the last rank's frame altered
where it is produced).
"""

from __future__ import annotations

import argparse
import json
import resource
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from perfbench import cells, check, reference, spec, stats  # noqa: E402


def _wrap_render(job, fault: str):
    render = job.render
    h, w = job.height, job.width
    prev = {}

    def faulty(cm):
        out = render(cm)
        if fault == "stale":
            last = prev.get("out", out)
            prev["out"] = out
            return last
        if fault == "half":
            return torch.cat([out[: h // 2], torch.zeros_like(out[h // 2:])])
        if fault == "altered":
            bump = torch.zeros_like(out)
            bump[h // 2, w // 2, 0] = 0.25
            return out + bump
        raise ValueError(fault)

    job.render = faulty


#: the function a fit_ranks run calls in every rank to plant a fault
FAULT_HOOK = "perfbench.calibrate:plant_rank_fault"


def plant_rank_fault(job, fault: str):
    """Break one rank's timed path underneath (``job`` a
    ``cells.RanksFitJob``): ``skip``, ``half``, ``altered`` as the module
    says; ``stale``, the optimizer skips its update; ``kill``, the last rank
    is killed at its third window step."""
    import os
    import signal

    import torch.distributed as dist

    rank, world = job.rank, job.world
    last = rank == world - 1
    if fault == "stale":
        job.opt.step = lambda *a, **k: None
    elif fault == "kill":
        step = job._step

        def killed(i):
            if last and i >= job.offset + 2:
                os.kill(os.getpid(), signal.SIGKILL)
            return step(i)

        job._step = killed
    elif fault in ("skip", "half"):
        all_reduce, n_volume = dist.all_reduce, job.volume.numel()
        kept = max(1, world // 2)

        def faulty(t, op=dist.ReduceOp.SUM, group=None, async_op=False):
            if group is None and fault == "skip" and last and not async_op and t.numel() == n_volume:
                return all_reduce(t.clone(), op=op, group=group, async_op=async_op)
            if group is None and fault == "half":
                t.mul_(world / kept if rank < kept else 0.0)
            return all_reduce(t, op=op, group=group, async_op=async_op)

        dist.all_reduce = faulty
    elif fault == "altered":
        from volym_tpu_torch.ops import slab_march

        render = slab_march.render_rays_diff

        def altered(*args, **kwargs):
            out = render(*args, **kwargs)
            if not last:
                return out
            flat = out.reshape(-1, 4)
            bump = torch.zeros_like(flat)
            bump[flat.shape[0] // 2, 0] = 0.25
            return (flat + bump).reshape(out.shape)

        slab_march.render_rays_diff = altered
    else:
        raise ValueError(f"unknown fault {fault!r}")


def control_notes(job) -> dict:
    """The control's numbers for a ``fit_ranks`` run, read after its check."""
    t0 = time.perf_counter()
    return {"control": job.numbers(program=torch.bfloat16), "control_s": time.perf_counter() - t0}


def one_ranks(cell: spec.Cell, seed: int, seconds: float, fault: str | None, device: str, backend: str,
              overrides: dict | None = None, ranks: int | None = None) -> dict:
    """A ``fit_ranks`` cell's readings: a whole run of every rank, ``fault``
    planted in each (:func:`plant_rank_fault`), then, on a sound run, the
    control."""
    import torch.distributed as dist

    from volym_tpu_torch.ops import slab_march

    from perfbench import ranks as ranks_mod

    t0 = time.perf_counter()
    cfg = dict(cell.config, **(overrides or {}))
    planted = dist.all_reduce, slab_march.render_rays_diff  # rank 0 is this process: undo its fault after
    try:
        result, notes = ranks_mod.run_cell(cell, cfg, seed, seconds, False, device, backend, t0, overrides=overrides,
                                           world=ranks, fault=[FAULT_HOOK, fault] if fault else None,
                                           extra=None if fault else control_notes)
    finally:
        dist.all_reduce, slab_march.render_rays_diff = planted
    out = {"seed": seed, "fault": fault, "ranks": ranks, "run_s": time.perf_counter() - t0,
           "numbers": {k: c["value"] for k, c in result["checks"].items()}, "metrics": result["metrics"],
           "memory_peak_bytes": result["device"]["memory_peak_bytes"]}
    out.update(notes)
    return out


def one(cell: spec.Cell, seed: int, seconds: float, fault: str | None, device: str, backend: str,
        overrides: dict | None = None) -> dict:
    cfg = dict(cell.config, **(overrides or {}))
    loop = cell.traffic["loop"]
    job = cells.JOBS[loop](cfg, cell.traffic, seed, device, backend)
    restore = None
    if fault is not None:
        if loop == "fit" and fault == "half":
            from volym_tpu_torch import optim

            restore = (optim, optim.l2_image_loss)
            optim.l2_image_loss = lambda img, target: torch.mean((img - target)[: job.height // 2] ** 2)
        elif loop == "fit" and fault == "stale":
            job.opt.step = lambda *a, **k: None
        else:
            _wrap_render(job, fault)
    try:
        if loop == "fit":
            job.first_image = None
            render = job.render

            def first(cm):
                out = render(cm)
                if job.first_image is None:
                    job.first_image = out.detach().clone()
                return out

            job.render = first
        job.warm_up()
        win = stats.run_window(job.issue, job.sync, seconds, keep=job.keep)
        job.next_index = job.finish(win.count)
    finally:
        if restore is not None:
            restore[0].l2_image_loss = restore[1]
    first_image = getattr(job, "first_image", None)
    job.release()
    torch.cuda.empty_cache() if torch.cuda.is_available() else None
    t0 = time.perf_counter()
    out = {"seed": seed, "fault": fault, "numbers": job.numbers()}
    out["reference_s"] = time.perf_counter() - t0
    if fault is None:
        t0 = time.perf_counter()
        out["control"] = job.numbers(program=torch.bfloat16)
        out["control_s"] = time.perf_counter() - t0
    if loop == "fit" and fault is None:
        want = job.reference_steps(torch.float32)
        out["losses"] = {"program": job.first["losses"], "reference": want["losses"]}
        out["grad_norms"] = {"program": check.norms(job.first["grad"]), "reference": check.norms(want["grad"])}
        out["change_norms"] = {"program": check.norms(job.first["change"]),
                               "reference": check.norms(want["change"])}
        img, _ = reference.render(job.start["volume"], job.importance, job.start["tf_lut"], job.matrices(0),
                                  job.ref_params, job.height, job.width)
        out["first_frame"] = check.frame_numbers([first_image], [img])
        out["torch_adam_witness"] = check.fit_numbers(torch_adam_steps(job), want)
        other = job.reference_steps(torch.float32, rows_per_block=128)
        out["block_order_witness"] = check.fit_numbers(other, want)
        out["block_order_losses"] = other["losses"]
        out["window"] = {"checked": job.checked, "program": job.window["losses"],
                         "reference": job.reference_window(torch.float32)["losses"],
                         "grad_norms": {"program": check.norms(job.program_window()["grad"]),
                                        "reference": check.norms(job.reference_window(torch.float32)["grad"])},
                         "block_order_witness": check.fit_numbers(job.reference_window(torch.float32, 128),
                                                                  job.reference_window(torch.float32))}
        out["work"] = getattr(job, "work_notes", {})
    return out


def torch_adam_steps(job) -> dict:
    """The reference's first steps with ``torch.optim.Adam`` and the
    projection, in place of the reference's own Adam."""
    leaves = {k: job.start[k].detach().clone().requires_grad_() for k in job.mix["leaves"]}
    opt = torch.optim.Adam(list(leaves.values()), lr=float(job.mix["learning_rate"]))
    out = {"losses": []}
    start = {k: v.detach().clone() for k, v in leaves.items()}
    for s in range(cells.FIT_CHECKED_STEPS):
        loss, d_vol, d_lut, _, _ = reference.loss_and_grads(
            leaves["volume"].detach(), job.importance, leaves["tf_lut"].detach(), job.matrices(s),
            job.targets[s % len(job.views)], job.ref_params, job.height, job.width)
        if s == 0:
            out["grad"] = {"volume": d_vol, "tf_lut": d_lut}
        out["losses"].append(loss)
        opt.zero_grad(set_to_none=True)
        leaves["volume"].grad, leaves["tf_lut"].grad = d_vol, d_lut
        opt.step()
        with torch.no_grad():
            for leaf in leaves.values():
                leaf.clamp_(0.0, 1.0)
    out["change"] = {k: leaves[k].detach() - start[k] for k in leaves}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--faults", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=1.5)
    ap.add_argument("--ranks", type=int, help="a fit_ranks cell's processes in place of its mix's")
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    cell = spec.load_cell(args.workload, ROOT)
    rows = []
    loop = cell.traffic["loop"]
    fault_names = {"fit": ["half", "altered"], "fit_ranks": ["skip", "half", "altered"]}.get(
        loop, ["half", "altered", "stale"])
    runs = [(s, None) for s in args.seeds] + [(s, f) for s in args.faults for f in fault_names]
    for seed, fault in runs:
        t0 = time.perf_counter()
        if loop == "fit_ranks":
            row = one_ranks(cell, seed, args.seconds, fault, "cuda", "slab_cuda", ranks=args.ranks)
        else:
            row = one(cell, seed, args.seconds, fault, "cuda", "slab_cuda")
        row["wall_s"] = time.perf_counter() - t0
        row["host_maxrss_gib"] = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20
        row["card_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        rows.append(row)
        print(json.dumps(row), flush=True)
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
