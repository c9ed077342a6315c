"""Spans at the port's layer boundaries, on the profiler's clock.

``with span("volym.grids"): ...`` records a ``torch.profiler.record_function``
range while torch's profiler is active (``cli.py --profile``, the
benchmark's traced runs), so Kineto writes it into the same trace as the
aten ops, the CUDA runtime calls and the device's activity: one clock, and
a span's parent is the span it nests in, on the autograd engine's worker
thread too.  With no profiler active it returns one shared no-op context
and enters no ``record_function``, which would cost about 15 us a span even
with nothing recording it.

The spans, each named ``volym.<layer>``:

- ``volym.render``: a call of a renderer that ``make_renderer`` returns;
- ``volym.grids``: ``ops/slab_march.py::grids``, the per-scene set-up, with
  ``volym.layout`` (``_layout``: the host read of the view matrix),
  ``volym.gradient_field`` (``_gradient_perm``) and
  ``volym.importance_levels`` (the look-ahead's levels) inside;
- ``volym.ray_table`` and ``volym.cone_table``: ``_features`` and
  ``_cone_features``, the per-ray and cone tables;
- ``volym.gate``, ``volym.march`` and ``volym.replay``: the dispatchers
  ``ops/lookahead.py::gate``, ``ops/slab_march.py::march`` and
  ``ops/slab_replay.py::replay``;
- ``volym.backward``: ``DiffMarch.backward``, with ``volym.replay`` and
  ``volym.fold`` (``smooth_backward``) inside.
"""

from __future__ import annotations

import contextlib

import torch
from torch.autograd import profiler as _profiler

_OFF = contextlib.nullcontext()


def span(name: str):
    """A context that records the range ``name`` while torch's profiler is
    active (the flag ``torch.profiler.profile`` sets on entry and clears on
    exit, read on each call), else a shared no-op."""
    if _profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _OFF
