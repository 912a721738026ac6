"""The traced run's record: spans around the benchmark's calls into the
port, one torch.profiler slice of the window, and the reduction of its
trace to what the per-layer metrics read.

Spans are ``torch.profiler.record_function`` ranges named ``bench.<name>``
(``job``, ``init_state``, ``render`` around the job's render call,
``resolve_image``, ``to_host``), recorded only inside the profiled slice. A device operation
(kernel, copy or fill) belongs to the span in which the host launched it:
the profiler correlates each with its runtime call, whatever the kernel is
named. The port's own launches are the kernels whose runtime call lies
outside every PyTorch operator; the slice counts them against the port's
launch counters and is profiled again, shorter, where the profiler missed
some.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile

import torch

from bench_torch import roofline

RENDER_SPANS = ("render",)
BLIT_SPANS = ("resolve_image",)
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
TRIES = 3

# the port's launch counters: (module, attribute) of path kernels and blit
PATH_COUNTERS = (("mega_regen", "LAUNCHES"), ("mega_regen", "BUDGET_LAUNCHES"),
                 ("mega_step", "LAUNCHES"), ("wavefront_fused", "LAUNCHES"),
                 ("wavefront_sweep", "LAUNCHES"))
BLIT_COUNTERS = (("tonemap", "LAUNCHES"),)


def launch_counts() -> dict:
    """The port's launch counters now: path kernels and blit."""
    import importlib

    def total(names):
        n = 0
        for mod, attr in names:
            m = importlib.import_module(f"tpurt_torch.kernels.{mod}")
            n += int(getattr(m, attr, 0))
        return n
    return {"path": total(PATH_COUNTERS), "blit": total(BLIT_COUNTERS)}


def _merge(intervals):
    """Disjoint sorted (start, end) covering the intervals."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _inside(merged, starts, t) -> bool:
    i = bisect.bisect_right(starts, t) - 1
    return i >= 0 and merged[i][0] <= t <= merged[i][1]


def reduce_trace(events: list) -> dict:
    """Spans, device operations and idle gaps of a chrome trace's
    complete events (times in microseconds)."""
    spans, cpu_ops, runtime, device = [], [], {}, []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, name = e.get("cat", ""), e.get("name", "")
        ts, dur = float(e["ts"]), float(e.get("dur", 0.0))
        if cat == "user_annotation" and name.startswith("bench."):
            spans.append((ts, ts + dur, name[len("bench."):]))
        elif cat == "cpu_op":
            cpu_ops.append((ts, ts + dur))
        elif cat in ("cuda_runtime", "cuda_driver"):
            corr = e.get("args", {}).get("correlation")
            if corr is not None:
                runtime[corr] = ts
        elif cat in DEVICE_CATS:
            device.append((ts, ts + dur, name,
                           e.get("args", {}).get("correlation"), cat))
    jobs = sorted(s for s in spans if s[2] == "job")
    inner = sorted(s for s in spans if s[2] != "job")
    inner_starts = [s[0] for s in inner]
    ops = _merge(cpu_ops)
    op_starts = [a for a, _ in ops]

    def span_at(t):
        i = bisect.bisect_right(inner_starts, t) - 1
        if i >= 0 and inner[i][0] <= t <= inner[i][1]:
            return inner[i][2]
        for a, b, _ in jobs:
            if a <= t <= b:
                return "job"
        return "outside"

    w0 = jobs[0][0] if jobs else 0.0
    w1 = jobs[-1][1] if jobs else 0.0
    by_span = {}
    for a, b, name in inner:
        d = by_span.setdefault(name, {"count": 0, "host_s": 0.0,
                                      "device_s": 0.0, "own_launches": 0})
        d["count"] += 1
        d["host_s"] += (b - a) * 1e-6
    ops_by_name = {}
    busy = []
    for a, b, name, corr, cat in device:
        launch = runtime.get(corr)
        where = span_at(launch) if launch is not None else "unlaunched"
        d = by_span.setdefault(where, {"count": 0, "host_s": 0.0,
                                       "device_s": 0.0, "own_launches": 0})
        d["device_s"] += (b - a) * 1e-6
        if cat == "kernel" and launch is not None \
                and not _inside(ops, op_starts, launch):
            d["own_launches"] += 1
        key = f"{where}:{name[:80]}"
        ops_by_name[key] = ops_by_name.get(key, 0.0) + (b - a) * 1e-6
        lo, hi = max(a, w0), min(b, w1)
        if hi > lo:
            busy.append((lo, hi))
    merged = _merge(busy)
    busy_s = sum(b - a for a, b in merged) * 1e-6
    gaps, t = [], w0
    for a, b in merged + [[w1, w1]]:
        if a > t:
            gaps.append((a - t, span_at(t)))
        t = max(t, b)
    gaps.sort(reverse=True)
    top_ops = sorted(ops_by_name.items(), key=lambda kv: -kv[1])[:10]
    return {
        "window_s": (w1 - w0) * 1e-6, "busy_s": busy_s, "spans": by_span,
        "jobs": len(jobs),
        "breakdown": {"device_ops": [[k, v] for k, v in top_ops],
                      "idle_gaps": [[name, g * 1e-6]
                                    for g, name in gaps[:10]]}}


def read_profile(prof) -> dict:
    """The chrome trace of a stopped profiler, reduced; the file is written
    to the run's temporary directory and deleted."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    return reduce_trace(events)


class Tracer:
    """Profiles one slice of the window's jobs (the mix's ``trace``),
    again at half its length where the profiler recorded fewer launches
    than the port counted, at most ``TRIES`` times."""

    def __init__(self, mix: dict, pixels: int, n_pixels: int):
        self.start = int(mix["trace"]["skip_jobs"])
        self.n = max(1, int(mix["trace"]["jobs"]))
        self.window_state = mix["state"] == "window"
        self.pixels, self.n_pixels = pixels, n_pixels
        self.slice = None
        self.prof = None
        self.record = None
        self.attempts = []

    def active(self, j: int) -> bool:
        return self.slice is not None and self.slice[0] <= j < self.slice[1]

    def span(self, name: str):
        return torch.profiler.record_function("bench." + name)

    def before_job(self, j: int) -> None:
        if self.record is not None or self.slice is not None \
                or j != self.start:
            return
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            torch.cuda.synchronize()
            acts.append(ProfilerActivity.CUDA)
        self.slice = (j, j + self.n)
        self.counts0 = launch_counts()
        self.prof = profile(activities=acts)
        self.prof.start()

    def after_job(self, j: int, jobs: list) -> None:
        if self.slice is None or j != self.slice[1] - 1:
            return
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.prof.stop()
        counted = launch_counts()
        rec = read_profile(self.prof)
        self.prof = None
        lo, hi = self.slice
        sl = jobs[lo:hi]
        rays = [int(x.rays) for x in jobs[max(lo - 1, 0):hi]]
        if self.window_state:
            # one accumulation: a job's segments are the count's increase
            segs = [b - a for a, b in zip(rays, rays[1:])] if lo > 0 \
                else [rays[0]] + [b - a for a, b in zip(rays, rays[1:])]
        else:
            segs = rays[-len(sl):]
        rec["frames"] = len(sl)
        rec["samples"] = sum(x.spp for x in sl)
        rec["segments"] = sum(segs)
        rec["pixels"], rec["n_pixels"] = self.pixels, self.n_pixels
        # a job's one render call reads and writes the planes once
        rec["path_bound_ms"] = sum(roofline.path_bound(self.pixels, s)[
            "bound_ms"] for s in segs)
        own = lambda names: sum(rec["spans"].get(n, {}).get(  # noqa: E731
            "own_launches", 0) for n in names)
        rec["launches"] = {
            "path": {"counted": counted["path"] - self.counts0["path"],
                     "recorded": own(RENDER_SPANS)},
            "blit": {"counted": counted["blit"] - self.counts0["blit"],
                     "recorded": own(BLIT_SPANS)}}
        rec["complete"] = all(v["counted"] == v["recorded"]
                              for v in rec["launches"].values())
        rec["slice"] = [lo, hi]
        self.attempts.append(rec)
        self.slice = None
        if rec["complete"] or len(self.attempts) >= TRIES:
            self.record = rec
        else:
            self.start, self.n = j + 1, max(1, self.n // 2)

    def done(self) -> bool:
        return self.record is not None
