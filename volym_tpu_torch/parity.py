"""The image tolerance rule this package is held to.

Two renders of one frame agree when the bulk of the entries is close and
only a small knife-edge population differs: samples whose density lands
within rounding of the threshold, or whose snapped coordinate sits on a
half-texel boundary, take the other side of the mask in one of the two
and move that pixel by O(one step).  The rule is the JAX package's own
(``tests/test_u8_stream.py::_close``): at most ``edge_frac`` of the entries
may differ by more than 1e-3 of the scale, and every other entry agrees to
``bulk`` of the scale.  A TF LUT gradient takes the rule in two groups
(:func:`check_lut_grad`), since its opaque end dwarfs the other entries.
A look-ahead gate is compared bit by bit (:func:`gate_diff`).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class Agreement:
    max_abs_err: float  # over all entries
    bulk_err: float  # over the entries within 1e-3 of the scale
    edge_frac: float  # share of entries off by more than 1e-3 of the scale
    scale: float


def _numpy(a) -> np.ndarray:
    if hasattr(a, "detach"):
        a = a.detach().cpu().numpy()
    return np.asarray(a, np.float64)


def agreement(a, b) -> Agreement:
    a, b = _numpy(a), _numpy(b)
    if a.shape != b.shape:
        raise ValueError(f"shapes differ: {a.shape} vs {b.shape}")
    scale = max(float(np.abs(a).max()), 1e-9)
    err = np.abs(a - b)
    ok = err / scale <= 1e-3
    return Agreement(
        max_abs_err=float(err.max()),
        bulk_err=float(err[ok].max()) if ok.any() else 0.0,
        edge_frac=float((~ok).mean()),
        scale=scale,
    )


def check_close(a, b, name: str, bulk: float = 2e-4, edge_frac: float = 2e-3) -> Agreement:
    """Raise ``AssertionError`` unless ``a`` and ``b`` agree by the rule."""
    r = agreement(a, b)
    if r.edge_frac > edge_frac:
        raise AssertionError(f"{name}: {r.edge_frac:.2e} of entries differ (limit {edge_frac:.0e})")
    if r.bulk_err > bulk * r.scale + 1e-12:
        raise AssertionError(f"{name}: bulk error {r.bulk_err:.2e} (limit {bulk * r.scale:.2e})")
    return r


def opaque_entries(lut) -> np.ndarray:
    """The (LN, 4) mask of the TF LUT gradient's entries at the opaque end:
    the alpha channel of the rows whose alpha is 1.  A sample there has
    ``1 - a`` floored at 1e-37, and the opacity correction's derivative
    ``aexp * (1 - a) ** (aexp - 1)`` (``aexp < 1``) reaches 1e15 and more,
    far above every other entry."""
    lut = _numpy(lut)
    mask = np.zeros(lut.shape, bool)
    mask[:, 3] = lut[:, 3] >= 1.0
    return mask


def check_lut_grad(a, b, lut, name: str, bulk: float = 2e-4, edge_frac: float = 2e-3) -> tuple[Agreement, float]:
    """Raise ``AssertionError`` unless two TF LUT gradients agree: the
    entries off the opaque end (:func:`opaque_entries`) by
    :func:`check_close` on their own scale, and each opaque-end entry to
    ``bulk`` of its own magnitude plus ``bulk`` of that scale.  One scale
    for both groups would let the opaque end's 1e15 hide every other
    entry.  -> (the agreement off the opaque end, the worst error of an
    opaque-end entry over its magnitude plus that scale: at most ``bulk``)."""
    a, b = _numpy(a), _numpy(b)
    if a.shape != b.shape:
        raise ValueError(f"shapes differ: {a.shape} vs {b.shape}")
    opaque = opaque_entries(lut)
    r = check_close(a[~opaque], b[~opaque], f"{name} (off the opaque end)", bulk, edge_frac)
    err = np.abs(a[opaque] - b[opaque])
    rel = err / (np.abs(a[opaque]) + r.scale)
    if (rel > bulk).any():
        i = int(np.argmax(rel))
        raise AssertionError(f"{name}: opaque-end entry off by {err[i]:.3e} of {a[opaque][i]:.3e}")
    return r, float(rel.max()) if rel.size else 0.0


@dataclass(frozen=True)
class GateDiff:
    n_bits: int  # (march step, ray) bits that differ
    rays: tuple[tuple[int, int], ...]  # the (row, col) pixels of the rays they fall on


def gate_diff(a, b) -> GateDiff:
    """Compare two (N, H, W) bool look-ahead gates bit by bit."""
    a, b = _numpy(a) > 0.5, _numpy(b) > 0.5
    if a.shape != b.shape:
        raise ValueError(f"shapes differ: {a.shape} vs {b.shape}")
    diff = a != b
    rows, cols = np.nonzero(diff.any(axis=0))
    return GateDiff(int(diff.sum()), tuple(zip(rows.tolist(), cols.tolist())))


def check_gate(a, b, name: str) -> GateDiff:
    """Raise ``AssertionError`` unless two look-ahead gates are equal bit
    for bit."""
    d = gate_diff(a, b)
    if d.n_bits:
        raise AssertionError(f"{name}: {d.n_bits} gate bits differ, on the rays at {list(d.rays[:8])}")
    return d
