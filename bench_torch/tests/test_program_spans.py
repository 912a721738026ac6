"""The readers of the program's spans (``program_spans.py`` and the
``program_span`` metrics) on the CPU: the spans of real ``render_step``
calls under the profiler, their launches given stand-in CUDA events with
known times; None without a card, on a program without the recorder, with
fewer calls than the slice's jobs and where a launch lacks its events."""

import collections
import importlib
import sys

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import tpurt_torch as tt
from bench_torch import program_spans
from tpurt_torch import tracing

torch.set_num_threads(1)
N = 10
HOST = ("driver_check_host_ms", "driver_prepare_host_ms")
DEVICE = {"path_kernel_device_ms": 14.5, "path_kernel_roofline": 100 / 145,
          "path_kernel_device_ms_p90": 18.0}


class Event:
    """A CUDA event's stand-in: a time in ms on one device clock."""

    def __init__(self, t):
        self.t = t

    def elapsed_time(self, end):
        return end.t - self.t


def read(name, rec):
    return importlib.import_module(f"bench_torch.metrics.{name}").read(rec)


@pytest.fixture(scope="module")
def traced():
    """The spans of one render_step outside the profiler, then N under
    it."""
    tracing.clear()
    cfg = tt.RenderConfig(width=8, height=4, depth=1, backend="pallas")
    scene = tt.cornell_spheres_scene(device="cpu")
    cam = tt.make_camera((0, 5, -12), (0, 5, 0), vfov=60.0,
                         aspect_ratio=2.0)
    st = tt.init_state(cfg, device="cpu")
    tt.render_step(scene, cfg, cam, st, 1)      # outside the slice
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(N):
            st = tt.render_step(scene, cfg, cam, st, 1)
    yield tracing.spans()
    tracing.clear()


@pytest.fixture
def rec(traced, monkeypatch):
    """The slice's record, the launches given events: call k's in
    [100 k + 3, 100 k + 13 + k]."""
    monkeypatch.setattr(tracing, "_records", collections.deque(traced))
    calls = [s for s in traced if s.name == "render"]
    for k, root in enumerate(calls):
        for s in traced:
            if s.call == root.id and s.name == "path.launch":
                s.events = (Event(100 * k + 3), Event(100 * k + 13 + k))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    return {"frames": N, "samples": N, "path_bound_ms": 1.0}


def test_readers_on_known_events(rec):
    for name, want in DEVICE.items():
        assert read(name, rec) == pytest.approx(want), name
    for name in HOST:
        v = read(name, rec)
        assert v is not None and v > 0.0, name
    s, n = program_spans.summary(rec)
    assert n == N
    assert read("driver_check_host_ms", rec) == pytest.approx(
        s["render.check"]["host_ms"] / N)


def test_calls_are_the_last_of_the_slice(rec):
    calls = program_spans.calls(dict(rec, frames=3))
    firsts = [c[0] for c in calls]
    roots = [s for s in tracing.spans() if s.name == "render"]
    assert firsts == roots[-3:]
    assert all(c[0].name == "render" and len(c) == 6 for c in calls)


@pytest.mark.parametrize("case", ["no_card", "no_recorder", "too_few",
                                  "no_events"])
def test_readers_find_nothing(rec, monkeypatch, case):
    if case == "no_card":
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    elif case == "no_recorder":     # the parent of the recorder's change
        monkeypatch.delattr(tt, "tracing")
        monkeypatch.setitem(sys.modules, "tpurt_torch.tracing", None)
    elif case == "too_few":
        rec = dict(rec, frames=N + 1)
    else:
        next(s for s in tracing.spans()
             if s.name == "path.launch").events = None
    for name in HOST + tuple(DEVICE):
        assert read(name, rec) is None, name
