"""The ``fit_ranks`` loop on the CPU: 2 and 4 gloo processes at a tiny size
on the plain slab backend (the card's look skipped), and the collectives'
metrics on made-up traces."""

import time

import pytest

from conftest import RANKS_CELL, ranks_run
from perfbench import layers, ranks, spec, stats, trace, work

KEYS = ["correct", "attempted", "failed", "metrics", "device"]
NCCL = "ncclDevKernel_AllReduce_Sum_f32_RING_LL(ncclDevKernelArgsStorage<4096ul>)"


@pytest.fixture(scope="module")
def runs(root):
    """One sound run at each world, shared by the tests that read it."""
    out = {}
    for world in (2, 4):
        proc, run = ranks_run(root, world)
        assert proc.returncode == 0, proc.stderr[-3000:]
        out[world] = run
    return out


@pytest.mark.parametrize("world", [2, 4])
def test_result_line_keys_and_replicas(root, runs, world):
    r = runs[world]["result"]
    assert list(r)[:5] == KEYS and list(r)[-1] == "checks"
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] >= 1
    cell = spec.load_cell(RANKS_CELL, root)
    assert set(r["metrics"]) == {m["name"] for m in cell.end_to_end} == {"step_ms", "setup_s"}
    assert r["device"]["count"] == world
    assert r["checks"]["replica_gap"] == {"value": 0.0, "limit": 0.0}
    assert "image_gap" not in r["checks"]
    assert set(r["checks"]) == set(cell.limits)


@pytest.mark.parametrize("world", [2, 4])
def test_every_rank_runs_the_same_steps(runs, world):
    steps = runs[world]["notes"]["rank_steps"]
    assert len(steps) == world and len(set(steps)) == 1
    assert steps[0] >= runs[world]["result"]["attempted"]


def test_a_killed_worker_ends_the_run(root):
    t0 = time.monotonic()
    proc, run = ranks_run(root, 4, seconds=30.0, fault="kill", timeout=120)
    assert proc.returncode not in (0, None) and run is None
    assert proc.stdout.strip() == ""
    assert time.monotonic() - t0 < 120


def test_a_rank_that_skips_the_volume_s_all_reduce_breaks_a_limit(root):
    proc, run = ranks_run(root, 4, fault="skip")
    assert proc.returncode == 0, proc.stderr[-3000:]
    checks = run["result"]["checks"]
    assert run["result"]["correct"] is False
    assert checks["replica_gap"]["value"] > checks["replica_gap"]["limit"] or (
        checks["grad_gap"]["value"] > checks["grad_gap"]["limit"])


def test_the_mix_s_ranks_must_be_the_cell_s_chips(root):
    cell = spec.load_cell(RANKS_CELL, root)
    assert cell.traffic["loop"] == "fit_ranks" and cell.traffic["ranks"] == cell.chips == 4


def test_the_window_is_a_step_count_fixed_in_set_up():
    assert ranks.window_steps(10.0, [0.5, 0.016, 0.015, 0.017]) == 606
    assert ranks.window_steps(0.001, [1.0]) == 1
    w = stats.run_window(lambda i: i, lambda out: None, 1e9, count=7)
    assert w.count == 7


def test_ranks_take_disjoint_cores(monkeypatch):
    import os

    set_to = {}
    monkeypatch.setattr(os, "sched_getaffinity", lambda pid: set(range(32)))
    monkeypatch.setattr(os, "sched_setaffinity", lambda tid, cores: set_to.__setitem__(tid, list(cores)))
    got = [ranks.pin_cores(k, 4) for k in range(4)]
    assert got == [list(range(8 * k, 8 * k + 8)) for k in range(4)]
    assert set_to and all(v == got[3] for v in set_to.values())
    set_to.clear()
    assert ranks.pin_cores(0, 1) == list(range(32)) and not set_to
    monkeypatch.setattr(os, "sched_getaffinity", lambda pid: {0, 1})
    assert ranks.pin_cores(2, 4) == [0, 1] and not set_to


def _ctx(device, items, ranks=4, cfg=None, peers=None):
    tr = trace.Trace(device=sorted(device, key=lambda r: r[1]), host=[])
    cfg = cfg or {"volume": {"side": 256}, "height": 192, "width": 1024}
    return layers.Context(cfg=cfg, planes=128, window=stats.Window(start=0.0), trace=tr, items=items, ranks=ranks,
                          peers=peers or [])


def _read(metric):
    return spec.load_reader(metric)


def test_busbw_is_the_fit_s_bytes_over_the_transfer_time():
    # two steps of 1000 us; rank 0's all-reduce kernels 400 + 100 us in the first, 500 us in the second;
    # its peer reached each all-reduce later and spent 150 + 50 and 250 us in it: the transfer
    device = [(NCCL, 100.0, 500.0), (NCCL, 600.0, 700.0), ("slab_replay_kernel", 0.0, 90.0),
              (NCCL, 1200.0, 1700.0)]
    peer = ([(NCCL, 5350.0, 5500.0), ("slab_replay_kernel", 5000.0, 5300.0), (NCCL, 5650.0, 5700.0),
             (NCCL, 6450.0, 6700.0)], [(5000.0, 6000.0), (6000.0, 7000.0)])
    ctx = _ctx(device, [(0.0, 1000.0), (1000.0, 2000.0)], peers=[peer])
    assert _read("allreduce_ms")(ctx) == pytest.approx(0.5)
    assert layers.transfer_ms(ctx, ["AllReduce"]) == pytest.approx((200.0 + 250.0) / 2 / 1e3)
    s = 256**3 * 4 + 256 * 4 * 4 + 4
    assert work.allreduce_bytes(ctx.cfg) == s == 67_112_964
    want = 100.0 * (s * 2 * 3 / 4) / 0.225e-3 / 450e9
    assert _read("allreduce_busbw_pct")(ctx) == pytest.approx(want)
    assert ctx.notes["allreduce_kernels"] == ["ncclDevKernel_AllReduce_Sum_f32_RING_LL"]
    assert ctx.notes["allreduce_transfer_ms"] == pytest.approx(0.225)
    assert ctx.notes["allreduce_wait_ms"] == pytest.approx(0.5 - 0.225)


def test_busbw_reads_nothing_without_a_peer_or_an_all_reduce():
    peer = ([(NCCL, 0.0, 5.0)], [(0.0, 100.0)])
    assert _read("allreduce_busbw_pct")(_ctx([(NCCL, 0.0, 10.0)], [(0.0, 100.0)], ranks=1, peers=[peer])) is None
    assert _read("allreduce_busbw_pct")(_ctx([(NCCL, 0.0, 10.0)], [(0.0, 100.0)])) is None
    assert _read("allreduce_busbw_pct")(_ctx([("slab_march_kernel", 0.0, 10.0)], [(0.0, 100.0)],
                                             peers=[([], [(0.0, 100.0)])])) is None
    assert _read("allreduce_ms")(_ctx([("slab_march_kernel", 0.0, 10.0)], [(0.0, 100.0)])) is None
    # the ranks' traces hold different collectives: no transfer time
    uneven = ([(NCCL, 0.0, 5.0), (NCCL, 6.0, 8.0)], [(0.0, 100.0)])
    assert layers.transfer_ms(_ctx([(NCCL, 0.0, 10.0)], [(0.0, 100.0)], peers=[uneven]), ["AllReduce"]) is None


def test_torch_ops_leave_out_the_collectives():
    device = [(NCCL, 100.0, 500.0), ("slab_replay_kernel", 0.0, 90.0), ("elementwise", 600.0, 650.0)]
    ctx = _ctx(device, [(0.0, 1000.0)])
    assert _read("torch_ops_ms.fit")(ctx) == pytest.approx(0.05)


def test_comm_exposed_is_the_all_reduce_time_no_other_kernel_covers():
    # step 1: all-reduce [100, 600), others [0, 300) and [250, 350) and [500, 550): exposed 250 - 50 = 200
    # step 2: all-reduce [1100, 1300) and [1200, 1400) (merged), nothing else: exposed 300
    device = [(NCCL, 100.0, 600.0), ("voxel_grad_kernel", 0.0, 300.0), ("elementwise", 250.0, 350.0),
              ("adam", 500.0, 550.0), (NCCL, 1100.0, 1300.0), (NCCL, 1200.0, 1400.0)]
    ctx = _ctx(device, [(0.0, 1000.0), (1000.0, 2000.0)])
    assert _read("comm_exposed_ms")(ctx) == pytest.approx((200.0 + 300.0) / 2 / 1e3)
    assert _read("comm_exposed_ms")(_ctx([("slab_march_kernel", 0.0, 10.0)], [(0.0, 100.0)])) is None


def test_overlap_of_merged_intervals():
    assert layers.overlap_us([(0, 10), (20, 30)], [(5, 25)]) == 10
    assert layers.overlap_us([(0, 10)], []) == 0
    assert layers.overlap_us([(0, 10)], [(0, 2), (3, 4), (9, 12)]) == 4
