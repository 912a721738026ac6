"""The control of every cell fails its check, the program passes it: the
plain reference computed in bfloat16 (the precision below the
configurations' float32) in the program's place, against the float32
reference, at 16x8, depth 3 (the torus smaller), on three seeds, with the
cell's own limits."""

import json
import pathlib
import time

import pytest
import torch

from bench_torch import check, harness, loop

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


@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_and_program_passes(workload):
    _, _, cell, limits, _ = harness.setup(workload, "cpu",
                                          time.perf_counter(),
                                          shrink(workload))
    for seed in (11, 2**31 + 5, 4000000007):
        if cell.mix["state"] == "job":
            cell.check_pixels = check.job_pixels(cell, seed)
        jobs, _, _, state, host = loop.run_window(cell, seed, 0.0)
        prog = check.program_outputs(cell, jobs, state, host, seed)
        want = check.reference_outputs(cell.config, prog, "cpu")
        ctrl = check.reference_outputs(cell.config, prog, "cpu",
                                       torch.bfloat16)
        ok, _ = check.judge(check.compare(prog, want), limits)
        ctrl_ok, checks = check.judge(check.compare(ctrl, want), limits)
        assert ok
        assert not ctrl_ok, checks


@pytest.mark.parametrize("shape", [(1920, 1080, 16), (1920, 1080, 33),
                                   (1920, 1080, 1000), (16, 8, 16),
                                   (16, 8, 500), (3, 1, 4)])
def test_grid_holds_at_least_the_count(shape):
    """The check samples at least the pixels it asks for (all of a smaller
    image), each once."""
    w, h, count = shape
    px = check.grid_pixels(5, w, h, count)
    assert len(px) >= min(count, w * h)
    assert len(set(px.tolist())) == len(px)
    assert int(px.min()) >= 0 and int(px.max()) < w * h
