"""Loading cells, configurations, traffic mixes and metrics by name."""

import json

import pytest

from perfbench import cells, spec


def test_every_cell_loads(root):
    bench = json.loads((root / "BENCHMARK.json").read_text())
    for w in bench["workloads"]:
        cell = spec.load_cell(w["name"], root)
        assert cell.config["name"] == w["config"]
        assert cell.traffic["loop"] in cells.JOBS
        assert {m["name"] for m in cell.end_to_end} >= {"setup_s"}
        assert cell.per_layer and cell.limits
        for m in cell.per_layer:
            assert callable(spec.load_reader(m["name"]))


def test_unknown_cell_is_refused(root):
    with pytest.raises(KeyError):
        spec.load_cell("no_such.cell", root)


def test_a_cell_added_from_files_alone(tmp_path, root):
    """A new configuration, traffic mix, metric and limits, each a file of
    its own, are found by the names in BENCHMARK.json."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    for sub in ("configs", "traffic", "metrics", "limits"):
        (tmp_path / "perfbench" / sub).mkdir(parents=True)
    base = tmp_path / "perfbench"
    cfg = json.loads((root / "perfbench/configs/bonsai256_default.json").read_text())
    cfg["name"] = "bonsai128_new"
    (base / "configs/bonsai128_new.json").write_text(json.dumps(cfg))
    (base / "traffic/slow_orbit.json").write_text(json.dumps(
        {"loop": "view", "cameras": "orbit", "degrees_per_frame": 0.5, "elevation_range": [0, 10],
         "elevation_degrees_per_frame": 0.1}))
    (base / "metrics/frame_count.py").write_text("def read(ctx):\n    return float(ctx.window.count)\n")
    (base / "limits/slow_orbit.bonsai128_new.json").write_text(json.dumps({"frame_off_share": {"limit": 0.0}}))
    bench["configs"].append({"name": "bonsai128_new", "source": "x", "file": "perfbench/configs/bonsai128_new.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "slow_orbit.bonsai128_new", "config": "bonsai128_new",
                               "traffic": "slow_orbit", "chips": 1, "why": "x"})
    bench["per_layer"].append({"name": "frame_count", "unit": "frames", "better": "higher", "source": "host_clock",
                               "layer": "Entry", "moves": "frame_ms", "workloads": ["slow_orbit.bonsai128_new"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = spec.load_cell("slow_orbit.bonsai128_new", tmp_path, base=base)
    assert cell.config["name"] == "bonsai128_new"
    assert cell.traffic["degrees_per_frame"] == 0.5
    assert [m["name"] for m in cell.per_layer] == ["frame_count"]
    assert cell.limits == {"frame_off_share": {"limit": 0.0}}

    class Ctx:
        class window:
            count = 7

    assert spec.load_reader("frame_count", base=base)(Ctx) == 7.0


def test_metrics_without_a_workloads_key_follow_their_end_to_end_metric():
    e2e = [{"name": "frame_ms"}, {"name": "setup_s"}]
    per_layer = [{"name": "a", "moves": "frame_ms"}, {"name": "b", "moves": "step_ms"},
                 {"name": "c", "moves": "step_ms", "workloads": ["x"]}]
    assert [m["name"] for m in spec.metrics_of(per_layer, "x", {m["name"] for m in e2e})] == ["a", "c"]
