"""A run with the timed path broken underneath comes out not correct: the
harness's whole run (set-up, window, check) on the CPU at 16x8, depth 3
(the torus smaller), with the look for a card skipped, once for each fault
a cell can have. A fault in the path launch is planted in each launcher a
backend can run: the regen kernel's and the wavefront tracers'.
(There is no exchange between chips: every cell takes one.)"""

import importlib
import json
import pathlib
import time

import pytest
import torch

import tpurt_torch
from bench_torch import harness
from bench_torch.reference.scenes import twin
from tpurt_torch.kernels import mega_regen
from tpurt_torch.kernels import tonemap as blit

CELLS = [w["name"] for w in json.loads(
    (pathlib.Path(harness.ROOT) / "BENCHMARK.json").read_text())["workloads"]]
# 16x8, depth 3, each scene at its twin's TINY_ARGS (the torus at 8x4
# segments), and short jobs, which the plain sweep (4096 padded lanes a
# sample) runs in seconds on the CPU
SHRINK = {"size": (16, 8, 3), "mix": {
    "spp": 4, "trace": {"skip_jobs": 0, "jobs": 1}}}


def shrink(workload):
    _, _, config, _, _ = harness.load(workload)
    return dict(SHRINK, args=twin(config["scene"]["builder"]).TINY_ARGS)


def unchanged(monkeypatch):
    """Every render call returns its state unchanged."""
    monkeypatch.setattr(tpurt_torch, "render_step",
                        lambda scene, cfg, cam, state, *a, **k: state)
    monkeypatch.setattr(tpurt_torch, "render",
                        lambda scene, cfg, cam, state, *a, **k: state)


def _each_launch(monkeypatch, fault):
    """``fault(before, after, n_pixels)`` on what each path launch leaves,
    as (P, C) pixel rows whose first three are the radiance sums: the
    planes of a regen launch, the rgb_sum of a wavefront tracer's."""
    real_regen = mega_regen.regen_call

    def regen_call(scene, cfg, camera, planes, *args):
        before = planes.clone()
        rays = real_regen(scene, cfg, camera, planes, *args)
        fault(before.T, planes.T, cfg.n_pixels)
        return rays
    monkeypatch.setattr(mega_regen, "regen_call", regen_call)

    render = importlib.import_module("tpurt_torch.render")
    real_dispatch = render._wavefront_dispatch

    def dispatch(cfg):
        launch = real_dispatch(cfg)

        def wavefront_launch(scene, cfg, camera, state, *args):
            out = launch(scene, cfg, camera, state, *args)
            fault(state.rgb_sum, out.rgb_sum, cfg.n_pixels)
            return out
        return wavefront_launch
    monkeypatch.setattr(render, "_wavefront_dispatch", dispatch)


def half_batch(monkeypatch):
    """The path kernel renders the first half of the image's pixels only;
    the rest keep their state."""
    def keep_second_half(before, after, n_pixels):
        after[n_pixels // 2:] = before[n_pixels // 2:]
    _each_launch(monkeypatch, keep_second_half)


def state_altered(monkeypatch):
    """The path kernel's radiance sums come out 1% high."""
    def one_percent_high(before, after, n_pixels):
        after[:, 0:3] *= 1.01
    _each_launch(monkeypatch, one_percent_high)


def image_altered(monkeypatch):
    """The blit's image comes out 0.01 high."""
    real = blit.tonemap_pixels
    monkeypatch.setattr(blit, "tonemap_pixels",
                        lambda *a, **k: real(*a, **k) + 0.01)


FAULTS = [unchanged, half_batch, state_altered, image_altered]


@pytest.mark.parametrize("fault", FAULTS, ids=lambda f: f.__name__)
@pytest.mark.parametrize("workload", CELLS)
def test_fault_is_not_correct(workload, fault, monkeypatch):
    fault(monkeypatch)
    out = harness.run(workload, 2**31 + 77, 0.0, False, time.perf_counter(),
                      device="cpu", shrink=shrink(workload))
    assert out["correct"] is False, out["checks"]


@pytest.mark.parametrize("workload", CELLS)
def test_sound_run_is_correct(workload):
    out = harness.run(workload, 2**31 + 77, 0.0, True, time.perf_counter(),
                      device="cpu", shrink=shrink(workload))
    assert out["correct"] is True, out["checks"]
    assert out["device"]["platform"] == "cpu"
    assert torch.cuda.is_available() or out["metrics"] == {}
