"""A run with the timed path broken underneath comes out not correct: the
harness's whole run (set-up, window, check) on the CPU at 16x8, depth 3
(the torus smaller), with the look for a card skipped, once for each fault
a cell can have.
(There is no exchange between chips: every cell takes one.)"""

import json
import pathlib
import time

import pytest
import torch

import tpurt_torch
from bench_torch import harness
from tpurt_torch.kernels import mega_regen
from tpurt_torch.kernels import tonemap as blit

CELLS = [w["name"] for w in json.loads(
    (pathlib.Path(harness.ROOT) / "BENCHMARK.json").read_text())["workloads"]]
# 16x8, depth 3; the torus at 8x4 segments and short jobs, which the
# plain sweep (4096 padded lanes a sample) runs in seconds on the CPU
SHRINK = {"size": (16, 8, 3), "args": {}, "mix": {
    "spp": 4, "trace": {"skip_jobs": 0, "jobs": 1}}}


def shrink(workload):
    _, _, config, _, _ = harness.load(workload)
    args = {"nu": 8, "nv": 4} if config["scene"]["builder"] == \
        "torus_mesh_scene" else {}
    return dict(SHRINK, args=args)


def unchanged(monkeypatch):
    """Every render call returns its state unchanged."""
    monkeypatch.setattr(tpurt_torch, "render_step",
                        lambda scene, cfg, cam, state, *a, **k: state)
    monkeypatch.setattr(tpurt_torch, "render",
                        lambda scene, cfg, cam, state, *a, **k: state)


def half_batch(monkeypatch):
    """The path kernel renders the first half of the image's pixels only;
    the rest keep their state."""
    real = mega_regen.regen_call

    def regen_call(scene, cfg, camera, planes, *args):
        half = cfg.n_pixels // 2
        keep = planes[:, half:].clone()
        rays = real(scene, cfg, camera, planes, *args)
        planes[:, half:] = keep
        return rays
    monkeypatch.setattr(mega_regen, "regen_call", regen_call)


def state_altered(monkeypatch):
    """The path kernel's radiance sums come out 1% high."""
    real = mega_regen.regen_call

    def regen_call(scene, cfg, camera, planes, *args):
        rays = real(scene, cfg, camera, planes, *args)
        planes[0:3] *= 1.01
        return rays
    monkeypatch.setattr(mega_regen, "regen_call", regen_call)


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
