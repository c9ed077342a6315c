"""Loading the benchmark's data by name.

``BENCHMARK.json`` names the cells; each cell names a configuration
(``configs/<name>.json``) and a traffic mix (``traffic/<name>.json``);
each per-layer metric is a reader ``metrics/<name>.py`` (with, for a
kernel metric, its patterns in ``metrics/<name>.json``); each cell's
correctness limits are ``limits/<cell>.json``.  A later change adds a cell,
a configuration, a mix or a metric by adding files and entries only.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

HERE = Path(__file__).resolve().parent


@dataclass(frozen=True)
class Cell:
    name: str
    config: dict
    traffic: dict
    chips: int
    end_to_end: list[dict]
    per_layer: list[dict]
    limits: dict


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def metrics_of(entries: list[dict], cell: str, reported: set[str] | None = None) -> list[dict]:
    """The metrics of ``entries`` that ``cell`` reports: those that list it
    under ``workloads``, and those without the key whose ``moves`` the cell
    reports (``reported``; None: every one without the key)."""
    out = []
    for m in entries:
        if "workloads" in m:
            if cell in m["workloads"]:
                out.append(m)
        elif reported is None or m.get("moves") in reported:
            out.append(m)
    return out


def load_cell(name: str, root: Path, base: Path = HERE) -> Cell:
    """The cell ``name`` of ``root``'s BENCHMARK.json, with its
    configuration, traffic mix and limits read from ``base``'s folders."""
    bench = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (have {sorted(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(root / configs[w["config"]]["file"])
    traffic = load_json(base / "traffic" / f"{w['traffic']}.json")
    e2e = metrics_of(bench["end_to_end"], name)
    per_layer = metrics_of(bench["per_layer"], name, {m["name"] for m in e2e})
    limits_path = base / "limits" / f"{name}.json"
    limits = load_json(limits_path) if limits_path.exists() else {}
    return Cell(name, config, traffic, int(w["chips"]), e2e, per_layer, limits)


def load_reader(metric: str, base: Path = HERE):
    """The ``read(ctx)`` function of ``metrics/<metric>.py``."""
    path = base / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"perfbench_metric_{metric.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def metric_data(metric: str, base: Path = HERE) -> dict:
    """A metric's own data file, ``metrics/<metric>.json``."""
    return load_json(base / "metrics" / f"{metric}.json")
