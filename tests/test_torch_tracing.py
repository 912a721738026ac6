"""tpurt_torch.tracing: the port's spans, on the CPU route (a GPU case
checks the launch's CUDA events; on a GPU machine: python3 -m pytest
tests/test_torch_tracing.py -m gpu --noconftest).

- Off (no profiler): nothing recorded, the same state bit for bit as a
  call under a profiler.
- Under ``torch.profiler.profile``: a ``render_step`` records ``render``
  with its children in order (each launcher's spans on its CPU route),
  nested in host time; the chrome trace holds them as ``tpurt.*``
  ``user_annotation`` ranges; ``summary``'s self times add up to the
  roots' host time; ``render_until`` records one ``until.welford`` a batch.
- The buffer keeps at most ``LIMIT`` spans; ``clear`` empties it; a
  device span's events come from a ring of ``PAIRS`` pairs.
"""

import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import tpurt_torch as tt
from tpurt_torch import tracing

CPU = "cpu"
torch.set_num_threads(1)
W, H = 16, 8
STATE_FIELDS = ("rgb_sum", "n_samples", "vis_pos", "vis_norm", "vis_wo",
                "vis_tp", "vis_mat", "rays")
CHAIN = ["render.check", "render.to_planes", "path.prepare", "path.launch",
         "render.from_planes"]
# backend -> (config keys, the render span's children in order; "*": one
# or more path.launch, the sweeps of the pool)
BACKENDS = {
    "regen": (dict(backend="pallas"), CHAIN),
    "tile_sync": (dict(backend="pallas", pallas_regen=False), CHAIN),
    "wavefront_fused": (dict(backend="wavefront_fused", wf_pool=128,
                             enable_photons=False),
                        ["render.check", "path.launch"]),
    "wavefront_pallas": (dict(backend="wavefront_pallas", wf_pool=128,
                              enable_photons=False),
                         ["render.check", "*"]),
}


@pytest.fixture(autouse=True)
def empty():
    tracing.clear()
    yield
    tracing.clear()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; on a GPU machine run "
                    "python3 -m pytest tests/test_torch_tracing.py -m gpu "
                    "--noconftest")
    return torch.device("cuda")


def _setup(device=CPU, **kw):
    cfg = tt.RenderConfig(width=W, height=H, depth=2, **kw)
    scene = tt.cornell_spheres_scene(device=device)
    cam = tt.make_camera((0, 5, -12), (0, 5, 0), vfov=60.0,
                         aspect_ratio=W / H)
    return scene, cfg, cam, tt.init_state(cfg, device=device)


def _traced(fn, activities=(ProfilerActivity.CPU,)):
    with profile(activities=list(activities)) as prof:
        out = fn()
    return out, prof


def test_off_records_nothing_and_changes_nothing():
    scene, cfg, cam, st = _setup(backend="pallas")
    off = tt.render_step(scene, cfg, cam, st, 7)
    assert tracing.spans() == []
    on, _ = _traced(lambda: tt.render_step(scene, cfg, cam, st, 7))
    assert [s.name for s in tracing.spans()][0] == "render"
    for f in STATE_FIELDS:
        assert torch.equal(getattr(off, f), getattr(on, f)), f
    assert (off.iteration, off.photon_radius) == (on.iteration,
                                                  on.photon_radius)


@pytest.mark.parametrize("backend", sorted(BACKENDS))
def test_render_step_spans_nest_in_order(backend):
    kw, want = BACKENDS[backend]
    scene, cfg, cam, st = _setup(**kw)
    _traced(lambda: tt.render_step(scene, cfg, cam, st, 7))
    spans = tracing.spans()
    root = spans[0]
    assert (root.name, root.parent, root.call) == ("render", None, root.id)
    kids = [s for s in spans if s.parent == root.id]
    names = [s.name for s in kids]
    if want[-1] == "*":
        assert names[:len(want) - 1] == want[:-1]
        assert set(names[len(want) - 1:]) == {"path.launch"}
    else:
        assert names == want
    assert len(kids) == len(spans) - 1      # no deeper spans
    for a, b in zip(kids, kids[1:]):
        assert a.t1_ns <= b.t0_ns
    for s in kids:
        assert s.call == root.id
        assert root.t0_ns <= s.t0_ns <= s.t1_ns <= root.t1_ns
        assert s.events is None     # a CPU state: no device interval


def test_chrome_trace_holds_the_spans(tmp_path):
    scene, cfg, cam, st = _setup(backend="pallas")
    _, prof = _traced(lambda: tt.render_step(scene, cfg, cam, st, 7))
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    got = [e["name"] for e in events if e.get("cat") == "user_annotation"
           and e["name"].startswith(tracing.PREFIX)]
    assert sorted(got) == sorted(tracing.PREFIX + n
                                 for n in ["render"] + CHAIN)


def test_summary_self_times_add_up():
    scene, cfg, cam, st = _setup(backend="pallas")

    def two():
        s1 = tt.render_step(scene, cfg, cam, st, 7)
        return tt.render(scene, cfg, cam, s1, 8, 2)
    _traced(two)
    spans = tracing.spans()
    s = tracing.summary(spans)
    assert s["render"]["count"] == 2
    assert s["path.launch"]["count"] == 2
    roots = sum(x.host_ms for x in spans if x.parent is None)
    assert sum(d["self_host_ms"] for d in s.values()) == pytest.approx(
        roots, rel=1e-9)
    for name, d in s.items():
        assert 0.0 <= d["self_host_ms"] <= d["host_ms"] + 1e-9, name
        assert d["device_ms"] is None
    assert s["render.check"]["self_host_ms"] == pytest.approx(
        s["render.check"]["host_ms"])


def test_render_until_records_one_welford_a_batch():
    scene, cfg, cam, st = _setup(backend="pallas")
    (_, info), _ = _traced(lambda: tt.render_until(
        scene, cfg, cam, st, 3, target_rel_err=0.0, batch_spp=1,
        max_spp=3))
    spans = tracing.spans()
    welford = [s for s in spans if s.name == "until.welford"]
    assert info["batches"] == 3 and len(welford) == 3
    assert all(s.parent is None for s in welford)
    assert len([s for s in spans if s.name == "render"]) == 3


def test_buffer_is_bounded_and_clear_empties_it(monkeypatch):
    monkeypatch.setattr(tracing, "LIMIT", 4)

    def many():
        for i in range(10):
            with tracing.span(f"s{i}"):
                pass
    _traced(many)
    spans = tracing.spans()
    assert [s.name for s in spans] == ["s6", "s7", "s8", "s9"]
    tracing.clear()
    assert tracing.spans() == []


def test_event_pairs_come_round(monkeypatch):
    """A device span takes the ring's next pair; once the ring has come
    round, the span that held the pair has no events left."""
    made = []

    class Event:
        def __init__(self, enable_timing):
            made.append(self)

        def record(self, stream):
            pass

    class Stream:
        device_index = 0

    monkeypatch.setattr(tracing, "PAIRS", 2)
    monkeypatch.setattr(tracing, "_rings", {})
    monkeypatch.setattr(torch.cuda, "Event", Event)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda d: Stream())

    def three():
        for i in range(3):
            with tracing.span(f"d{i}", torch.device("cuda", 0)):
                pass
    _traced(three)
    d0, d1, d2 = tracing.spans()
    assert len(made) == 4
    assert d0.events is None and d1.events == tuple(made[2:])
    assert d2.events == tuple(made[:2])


@pytest.mark.gpu
def test_cuda_launch_spans_carry_events(cuda):
    scene, cfg, cam, st = _setup(cuda, backend="pallas")
    tt.render_step(scene, cfg, cam, st, 7)      # builds the kernels
    _traced(lambda: tt.render_step(scene, cfg, cam, st, 7),
            (ProfilerActivity.CPU, ProfilerActivity.CUDA))
    torch.cuda.synchronize()
    spans = tracing.spans()
    timed = [s for s in spans if s.events is not None]
    assert [s.name for s in timed] == ["path.launch"]
    assert timed[0].device_ms() > 0.0
    s = tracing.summary(spans)
    assert s["path.launch"]["device_ms"] == pytest.approx(
        timed[0].device_ms())
    assert s["path.prepare"]["count"] == 1  # checks, plan and arguments
    assert s["render.to_planes"]["device_ms"] is None
