"""volym_tpu_torch.bench.harness against the JAX package's harness: the
sweep's constants, statistics, row order, parameters and CSV schema, the
trial loop's counting, the fence and clocks on the CPU, and the scaling
table on virtual CPU shards."""

import csv

import numpy as np
import pytest
import torch

from volym_tpu.bench import harness as jharness
from volym_tpu_torch import convert
from volym_tpu_torch.bench import harness


@pytest.mark.parametrize(
    "trials",
    [[(100, 2.0), (120, 2.0), (110, 2.0)], [(8, 0.25)], [(3, 0.1), (17, 2.7), (256, 2.0000001), (9, 0.03)]],
)
def test_trial_stats_equal_jax(trials):
    mine, theirs = harness.TrialResults(), jharness.TrialResults()
    for frames, seconds in trials:
        mine.add_trial(frames, seconds)
        theirs.add_trial(frames, seconds)
    got, want = mine.stats(), theirs.stats()
    assert list(got) == list(want)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-12, atol=0, err_msg=key)
    # population standard deviation, as the reference's calculate_stats
    np.testing.assert_allclose(got["std_dev_total_frames"], np.std([f for f, _ in trials]), rtol=1e-12)


def test_constants_and_schema_equal_jax():
    for name in ("NUM_TRIALS", "SECS_PER_TRIAL", "STEP_SIZES", "IMPORTANCE_STEPS", "BENCH_WIDTH", "BENCH_HEIGHT",
                 "CSV_FIELDS", "SCALING_CSV_FIELDS", "DISPATCH_BATCH"):
        assert getattr(harness, name) == getattr(jharness, name), name


def _sweep(module, **kw):
    """(rows, the params each row asked the factory for) of ``module``'s
    sweep with frames that do nothing."""
    calls = []

    def factory(params):
        calls.append(params)
        return lambda: None

    rows = module.benchmark_all(factory, num_trials=1, seconds=0.0, height=4, width=3, log=lambda *a: None, **kw)
    return rows, calls


@pytest.mark.parametrize("kw", [{}, dict(step_sizes=(0.02,)), dict(step_sizes=(0.005, 0.01), importance_steps=(7,))])
def test_benchmark_all_rows_and_params_equal_jax(kw, tmp_path):
    rows, calls = _sweep(harness, **kw)
    jrows, jcalls = _sweep(jharness, **kw)
    n_steps = len(kw.get("step_sizes", harness.STEP_SIZES))
    assert len(rows) == n_steps * (1 + 2 * len(kw.get("importance_steps", harness.IMPORTANCE_STEPS)))
    key = ("algorithm", "step_size", "importance_steps", "use_cone")
    assert [tuple(r[k] for k in key) for r in rows] == [tuple(r[k] for k in key) for r in jrows]
    assert calls == [convert.render_params(p) for p in jcalls]
    assert all(r["rays_per_s"] > 0 for r in rows)
    # the same CSV header
    harness.write_csv(rows, tmp_path / "port.csv")
    jharness.write_csv(jrows, tmp_path / "jax.csv")
    with open(tmp_path / "port.csv") as f, open(tmp_path / "jax.csv") as g:
        assert next(csv.reader(f)) == next(csv.reader(g)) == harness.CSV_FIELDS + ["rays_per_s"]
        assert len(list(csv.reader(f))) == len(rows)


def test_write_csv_of_no_rows_writes_nothing(tmp_path):
    harness.write_csv([], tmp_path / "none.csv")
    assert not (tmp_path / "none.csv").exists()


@pytest.mark.parametrize("batch", [1, 8])
def test_run_trial_counts(batch):
    n = {"count": 0}

    def frame():
        n["count"] += 1

    frames, dur = harness.run_trial(frame, seconds=0.05, warmup=1, batch=batch)
    assert frames >= 1 and frames % batch == 0
    assert n["count"] == frames + 1  # the warm-up frame is not counted
    assert dur >= 0.05


def test_run_trial_fences_every_batch(monkeypatch):
    n = {"frames": 0}
    fenced = []

    def frame():
        n["frames"] += 1
        return [torch.full((2,), float(n["frames"]))]

    def spy(out, fence=harness.force_sync):
        fenced.append(fence(out))
        return fenced[-1]

    monkeypatch.setattr(harness, "force_sync", spy)
    frames, _ = harness.run_trial(frame, seconds=0.0, warmup=2, batch=4)
    # the warm-up frame fenced, one frame not counted, then 4 frames and a fence
    assert frames == 4 and fenced == [1.0, 6.0]


def test_force_sync():
    t = torch.arange(6.0).reshape(2, 3) + 2.5
    assert harness.force_sync(None) == 0.0
    assert harness.force_sync(()) == 0.0
    assert harness.force_sync({"x": None}) == 0.0
    assert harness.force_sync(t) == 2.5
    assert harness.force_sync((None, [t * 2])) == 5.0
    # a dict's values in key order, as JAX flattens one
    assert harness.force_sync({"b": t, "a": t * 3}) == 7.5
    # a tensor that carries a gradient
    assert harness.force_sync(t.clone().requires_grad_(True) * 1.0) == 2.5
    assert isinstance(harness.force_sync(t.int()), float)


def test_marginal_time_of_a_cpu_op():
    a = torch.rand(64, 64, generator=torch.Generator().manual_seed(0))
    sec = harness.marginal_time(lambda: a @ a, iters=10, warmup=1)
    assert 0 < sec < 1.0
    assert harness.marginal_time(lambda: a @ a, iters=1, warmup=0) > 0


def test_scaling_table_not_ported():
    """``scaling_table``, which needed the then unported
    ``volym_tpu_torch.parallel``, runs on virtual CPU shards: the JAX
    package's rows (``test_scaling_table_on_virtual_mesh``), its counts that
    divide the rays only, and no default device without CUDA."""
    from volym_tpu_torch import Camera, RenderParams, Scene

    params = RenderParams(use_gaussian_smoothing=False, raymarching_step_size=0.1, max_steps=40, use_shading=False)
    scene, cam = Scene.synthetic("sphere", side=16), Camera(aspect=1.0, distance=1.1).orbit(25.0, 10.0, 0.0)
    rows = harness.scaling_table(scene, cam.matrices(), params, 16, 16, devices=[torch.device("cpu")] * 8,
                                 device_counts=[1, 2, 3, 8], backend="slab", num_trials=1, seconds=0.05,
                                 log=lambda *a: None)
    assert [r["devices"] for r in rows] == [1, 2, 8]
    assert list(rows[0]) == jharness.SCALING_CSV_FIELDS
    for r in rows:
        assert r["rays_per_s"] > 0 and r["scaling_efficiency"] > 0
    assert rows[0]["scaling_efficiency"] == 1.0
    assert [r["devices"] for r in harness.scaling_table(
        scene, cam.matrices(), params, 16, 16, devices=[torch.device("cpu")] * 8, backend="slab", num_trials=1,
        seconds=0.0, log=lambda *a: None)] == [1, 2, 4, 8]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            harness.scaling_table(scene, cam.matrices(), params, 16, 16)
