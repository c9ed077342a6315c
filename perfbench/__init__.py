"""The benchmark of ``volym_tpu_torch``, the PyTorch and CUDA port of volym.

``python perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` once and prints one JSON line.  The
cells, configurations, traffic mixes and per-layer metrics are data found
by name under ``configs/``, ``traffic/``, ``metrics/`` and ``limits/``.
Everything here that computes a yardstick (the inputs, the plain
reference, the work counts, the peaks, the trace reduction) imports
nothing of the program; only ``cells.py`` drives the program.
"""
