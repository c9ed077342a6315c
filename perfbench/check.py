"""The comparisons that decide ``correct``: each number compared is held to
its limit in ``limits/<cell>.json``, set from the readings of sound runs
and of the control (``PERF.md`` gives the readings)."""

from __future__ import annotations

import statistics

import torch

#: an image entry farther than this from the reference's counts as off
OFF_ABS = 1e-3


def frame_numbers(program: list[torch.Tensor], reference: list[torch.Tensor]) -> dict[str, float]:
    """Frames against the reference's: the largest share of a frame's
    entries off by more than OFF_ABS, and the largest gap of any entry."""
    share, gap = 0.0, 0.0
    for a, b in zip(program, reference, strict=True):
        d = (a.float() - b.float()).abs()
        d = torch.where(torch.isnan(d), torch.inf, d)
        share = max(share, float((d > OFF_ABS).float().mean()))
        gap = max(gap, float(d.max()))
    return {"frame_off_share": share, "frame_gap_max": gap}


def norms(tensors: dict[str, torch.Tensor]) -> dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in tensors.items()}


def fit_numbers(program: dict, reference: dict) -> dict[str, float]:
    """A training job's first steps against the reference's.  ``program``
    and ``reference`` hold ``losses`` (each step's loss), ``grad`` (each
    leaf's first gradient, as the optimizer got it) and ``change`` (each
    leaf's change over the steps).  The loss gap is the worst step's.  The
    gaps of norms are taken by the worst leaf, against the reference's norm
    of that leaf or of the median leaf, whichever is larger; a leaf whose
    reference gradient is under a thousandth of the median leaf's is left
    out of the change."""
    loss_gap = max(abs(p - r) / abs(r) for p, r in zip(program["losses"], reference["losses"], strict=True))
    gp, gr = norms(program["grad"]), norms(reference["grad"])
    cp, cr = norms(program["change"]), norms(reference["change"])
    g_med, c_med = statistics.median(gr.values()), statistics.median(cr.values())
    grad_gap = max(abs(gp[k] - gr[k]) / max(gr[k], g_med) for k in gr)
    moving = [k for k in cr if gr[k] >= 1e-3 * g_med]
    change_gap = max(abs(cp[k] - cr[k]) / max(cr[k], c_med) for k in moving)
    return {"loss_gap": loss_gap, "grad_gap": grad_gap, "change_gap": change_gap}


def judge(numbers: dict[str, float], limits: dict) -> tuple[bool, dict]:
    """(correct, each number beside its limit).  A number without a limit,
    or one that is not a number, fails."""
    out, ok = {}, True
    for name, value in numbers.items():
        limit = limits.get(name, {}).get("limit")
        out[name] = {"value": value, "limit": limit}
        if limit is None or not (value == value) or value > limit:
            ok = False
    return ok, out
