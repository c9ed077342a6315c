"""The control and the faults: a run with the timed path broken underneath,
or with the plain reference in bfloat16 in the program's place, comes out
not correct.  On the CPU at a tiny size, the card's look skipped."""

import pytest
import torch

from conftest import RANKS_CELL, ranks_run, tiny
from perfbench import calibrate, cells, check, run, spec

SEED = 2**31 + 99


def _run(root, name):
    cell = spec.load_cell(name, root)
    return run.run_cell(name, SEED, 0.2, False, device="cpu", backend="slab", overrides=tiny(cell))[0]


def _wrap_renderer(monkeypatch, alter):
    from volym_tpu_torch.render import renderer

    make = renderer.make_renderer

    def faulty(*args, **kwargs):
        render = make(*args, **kwargs)
        state = {}

        def call(cm):
            return alter(render(cm), state)

        return call

    monkeypatch.setattr(renderer, "make_renderer", faulty)


def _stale(out, state):
    prev = state.get("prev", out)
    state["prev"] = out
    return prev


def _half(out, state):
    h = out.shape[0]
    return torch.cat([out[: h // 2], torch.zeros_like(out[h // 2:])])


def _altered(out, state):
    bump = torch.zeros_like(out)
    bump[out.shape[0] // 2, out.shape[1] // 2, 0] = 0.25
    return out + bump


@pytest.mark.parametrize("name", ["orbit_view.bonsai256_default", "orbit_view.teapot256_cone"])
@pytest.mark.parametrize("fault", [_stale, _half, _altered], ids=["stale", "half", "altered"])
def test_view_faults_come_out_not_correct(root, monkeypatch, name, fault):
    _wrap_renderer(monkeypatch, fault)
    r = _run(root, name)
    assert r["correct"] is False and r["failed"] >= 1


def test_fit_state_left_unchanged_comes_out_not_correct(root, monkeypatch):
    monkeypatch.setattr(torch.optim.Adam, "step", lambda self, closure=None: None)
    r = _run(root, "fit_views.bonsai256_default")
    assert r["correct"] is False and r["checks"]["change_gap"]["value"] == pytest.approx(1.0)


def test_fit_half_of_the_frame_comes_out_not_correct(root, monkeypatch):
    from volym_tpu_torch import optim

    monkeypatch.setattr(optim, "l2_image_loss", lambda img, target: torch.mean((img - target)[: img.shape[0] // 2] ** 2))
    assert _run(root, "fit_views.bonsai256_default")["correct"] is False


def test_fit_altered_frame_comes_out_not_correct(root, monkeypatch):
    _wrap_renderer(monkeypatch, _altered)
    assert _run(root, "fit_views.bonsai256_default")["correct"] is False


def test_fit_fault_in_the_window_alone_comes_out_not_correct(root, monkeypatch):
    """A frame altered only from the window's first step on, after the
    steps that set-up checks: the checked window steps catch it."""
    from volym_tpu_torch.render import renderer

    make = renderer.make_renderer

    def faulty(*args, **kwargs):
        render = make(*args, **kwargs)
        calls = {"n": 0}

        def call(cm):
            calls["n"] += 1
            out = render(cm)
            return _altered(out, {}) if calls["n"] > cells.FIT_CHECKED_STEPS + 16 else out

        return call

    monkeypatch.setattr(renderer, "make_renderer", faulty)
    r = _run(root, "fit_views.bonsai256_default")
    assert r["correct"] is False
    assert all(r["checks"][k]["value"] <= r["checks"][k]["limit"] for k in ("loss_gap", "grad_gap", "change_gap"))


def test_a_sound_run_is_correct(root):
    assert _run(root, "fit_views.bonsai256_default")["correct"] is True


@pytest.mark.parametrize("name", ["orbit_view.bonsai256_default", "orbit_view.teapot256_cone",
                                  "fit_views.bonsai256_default"])
def test_the_bfloat16_control_comes_out_not_correct(root, name):
    cell = spec.load_cell(name, root)
    reading = calibrate.one(cell, SEED, 0.1, None, "cpu", "slab", tiny(cell, side=24, width=24, height=16))
    assert check.judge(reading["numbers"], cell.limits)[0] is True
    assert check.judge(reading["control"], cell.limits)[0] is False


@pytest.mark.parametrize("fault", ["skip", "half", "stale"])
def test_ranks_faults_come_out_not_correct(root, fault):
    """Over 2 gloo ranks: the last rank steps on its own rows' volume
    gradient (the exchange left out), the upper half of the ranks leave their
    rows out (the mean taken over the rest), the optimizer skips its update."""
    proc, out = ranks_run(root, 2, fault=fault)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert out["result"]["correct"] is False and out["result"]["failed"] >= 1
    if fault == "stale":
        assert out["result"]["checks"]["change_gap"]["value"] == pytest.approx(1.0)


def test_the_ranks_bfloat16_control_comes_out_not_correct(root):
    proc, out = ranks_run(root, 2, control=True)
    assert proc.returncode == 0, proc.stderr[-3000:]
    limits = spec.load_cell(RANKS_CELL, root).limits
    assert out["result"]["correct"] is True
    assert check.judge(out["notes"]["control"], limits)[0] is False
