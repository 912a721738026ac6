"""One traced window of a cell on the card, with the program's spans
(``tpurt_torch.tracing``) held against the profiler's trace of the same
slice and against the benchmark's own ``bench.render`` ranges:

    python3 bench_torch/crosscheck.py --workload <cell> --seed <n> \\
        --seconds <s>

Prints ``crosscheck <json>`` for the final traced slice, per render call:

- ``host``: the program's ``render`` span in host ms against the
  ``bench.render`` range around the same call (``driver_host_ms``);
  ``host_ok`` where they differ by at most 0.1 ms;
- ``device``: the CUDA events of ``path.launch`` (what
  ``path_kernel_device_ms`` reads) plus the trace's device time of the
  operations launched in the other spans, against the trace's device time
  of everything launched in ``bench.render`` (``path_device_ms`` x
  samples); ``device_ok`` within 5%;
- ``launch``: the events of ``path.launch`` against the trace's device
  time of the kernel it launched;
- ``plane_pass_device_ms``: the trace's device time of what
  ``render.to_planes`` and ``render.from_planes`` launched;
- ``gap_device_ms``: on the device's timeline, from the end of the last
  operation ``render.to_planes`` launched to the start of the first one
  ``path.launch`` launched (the prepare step's copies and the device idle
  while the host builds the launch);
- ``idle_by_host_span``: the device's idle time in the slice, split by the
  innermost range (``tpurt.*`` or ``bench.*``) the host was in meanwhile;
- ``spans``: per span name, host, self host and event ms, and the trace's
  device ms of what was launched in it (innermost span);
- ``per_call``: quantiles over the calls of the launch's event ms and of
  the ``render`` span's host ms; ``slow_launches``: the slice's calls
  (from 0) whose launch took over twice the median.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import bisect  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

from bench_torch import harness, loop, program_spans, trace  # noqa: E402

HOST_MS = 0.1
DEVICE_SHARE = 0.05
PREFIXES = ("tpurt.", "bench.")


class KeptTrace(trace.Tracer):
    """The benchmark's tracer, keeping the chrome trace of its last slice:
    its profiler is handed out behind ``_Kept``, which keeps a copy of
    the trace as the tracer exports it."""

    events = None

    def before_job(self, j: int) -> None:
        super().before_job(j)
        if self.prof is not None and not isinstance(self.prof, _Kept):
            self.prof = _Kept(self.prof, self)


class _Kept:
    """A profiler whose exported chrome trace also lands in
    ``owner.events``."""

    def __init__(self, prof, owner):
        self.prof, self.owner = prof, owner

    def __getattr__(self, name):
        return getattr(self.prof, name)

    def export_chrome_trace(self, path: str) -> None:
        self.prof.export_chrome_trace(path)
        with open(path) as f:
            self.owner.events = json.load(f)["traceEvents"]


def ranges_and_ops(events: list):
    """The ``tpurt.*`` and ``bench.*`` ranges (start, end, name with its
    prefix) in order of start, and the device operations (host launch
    time, device start, device end), times in microseconds."""
    ranges, runtime, device = [], {}, []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, name = e.get("cat", ""), e.get("name", "")
        ts, dur = float(e["ts"]), float(e.get("dur", 0.0))
        corr = e.get("args", {}).get("correlation")
        if cat == "user_annotation" and name.startswith(PREFIXES):
            ranges.append((ts, ts + dur, name))
        elif cat in ("cuda_runtime", "cuda_driver") and corr is not None:
            runtime[corr] = ts
        elif cat in trace.DEVICE_CATS:
            device.append((corr, ts, ts + dur))
    ops = sorted((runtime[c], a, b) for c, a, b in device if c in runtime)
    return sorted(ranges), ops


def innermost(ranges: list, starts: list, t: float):
    """The index of the latest-opened of ``ranges`` (in order of start,
    ``starts`` their starts) still open at ``t``, or -1."""
    i = bisect.bisect_right(starts, t) - 1
    while i >= 0 and ranges[i][1] < t:
        i -= 1
    return i


def program_ops(ranges: list, ops: list):
    """The program's ``render`` calls (start, end) in order, and each
    device operation launched inside one as (call index, the innermost
    ``tpurt.*`` span's name, device start, device end)."""
    spans = [r for r in ranges if r[2].startswith("tpurt.")]
    calls = [r for r in spans if r[2] == "tpurt.render"]
    span_starts, call_starts = [r[0] for r in spans], [r[0] for r in calls]
    out = []
    for t, a, b in ops:
        k = innermost(calls, call_starts, t)
        i = innermost(spans, span_starts, t)
        if k >= 0 and i >= 0:
            out.append((k, spans[i][2][len("tpurt."):], a, b))
    return calls, out


def host_timeline(ranges: list, lo: float, hi: float) -> list:
    """(start, end, name) pieces of [lo, hi], each named by the innermost
    range the host was in (``outside`` where none)."""
    marks = sorted({lo, hi} | {t for r in ranges for t in r[:2]
                               if lo < t < hi})
    starts = [r[0] for r in ranges]
    pieces = []
    for a, b in zip(marks, marks[1:]):
        i = innermost(ranges, starts, (a + b) / 2)
        pieces.append((a, b, ranges[i][2] if i >= 0 else "outside"))
    return pieces


def idle_by_host_span(ranges: list, ops: list, lo: float, hi: float):
    """Device idle ms in [lo, hi] by the innermost host range open
    meanwhile."""
    busy = trace._merge([(max(a, lo), min(b, hi)) for _, a, b in ops
                         if b > lo and a < hi])
    idle, t = [], lo
    for a, b in busy + [[hi, hi]]:
        if a > t:
            idle.append((t, a))
        t = max(t, b)
    out = {}
    for a, b, name in host_timeline(ranges, lo, hi):
        for u, v in idle:
            w = min(b, v) - max(a, u)
            if w > 0:
                out[name] = out.get(name, 0.0) + w * 1e-3
    return out


def quantiles(ms: list) -> dict:
    """Median, 90th and 99th percentile (nearest rank) and max."""
    q = sorted(ms)
    at = lambda p: q[math.ceil(p * len(q)) - 1]  # noqa: E731
    return {"median": at(0.5), "p90": at(0.9), "p99": at(0.99),
            "max": q[-1], "over_2x_median": sum(v > 2 * at(0.5) for v in q)}


def crosscheck(rec: dict, events: list) -> dict:
    """The checks and splits above, for the slice ``rec`` whose chrome
    trace is ``events``."""
    calls = program_spans.calls(rec)
    s, n = program_spans.summary(rec)
    ranges, ops = ranges_and_ops(events)
    prog_calls, prog_ops = program_ops(ranges, ops)
    prog_calls, first = prog_calls[-n:], len(prog_calls) - n
    by_span = {}
    launch_ms = [0.0] * n
    last_planes = [None] * n
    first_launch = [None] * n
    for k, name, a, b in prog_ops:
        if k < first:
            continue
        c = k - first
        by_span[name] = by_span.get(name, 0.0) + (b - a) * 1e-3
        if name == "path.launch":
            launch_ms[c] += (b - a) * 1e-3
            first_launch[c] = a if first_launch[c] is None \
                else min(first_launch[c], a)
        elif name == "render.to_planes":
            last_planes[c] = b if last_planes[c] is None \
                else max(last_planes[c], b)
    gaps = [(u - p) * 1e-3 for p, u in zip(last_planes, first_launch)
            if p is not None and u is not None]
    events_ms = [sum(x.device_ms() for x in c if x.name == "path.launch")
                 for c in calls]
    host_ms = [c[0].host_ms for c in calls]
    bench = rec["spans"]["render"]
    host = (s["render"]["host_ms"] / n,
            bench["host_s"] * 1e3 / bench["count"])
    others = sum(v for k, v in by_span.items() if k != "path.launch")
    device = ((s["path.launch"]["device_ms"] + others) / n,
              bench["device_s"] * 1e3 / n)
    lo, hi = prog_calls[0][0], prog_calls[-1][1]
    idle = idle_by_host_span(ranges, ops, lo, hi)
    med = quantiles(events_ms)["median"]
    return {
        "calls": n, "samples": rec["samples"],
        "host": {"program_ms": host[0], "bench_ms": host[1]},
        "host_ok": abs(host[0] - host[1]) <= HOST_MS,
        "device": {"program_ms": device[0], "bench_ms": device[1]},
        "device_ok": abs(device[0] - device[1]) <= DEVICE_SHARE * device[1],
        "launch": {"event_ms": sum(events_ms) / n,
                   "profiler_ms": sum(launch_ms) / n},
        "plane_pass_device_ms": (by_span.get("render.to_planes", 0.0)
                                 + by_span.get("render.from_planes", 0.0))
        / n,
        "gap_device_ms": quantiles(gaps) if gaps else None,
        "gap_device_ms_mean": sum(gaps) / len(gaps) if gaps else None,
        "idle_by_host_span": {k: v / n for k, v in sorted(
            idle.items(), key=lambda kv: -kv[1])},
        "per_call": {"path.launch (events)": quantiles(events_ms),
                     "render (host)": quantiles(host_ms)},
        "slow_launches": [i for i, v in enumerate(events_ms) if v > 2 * med],
        "spans": {k: {"host_ms": d["host_ms"] / n,
                      "self_host_ms": d["self_host_ms"] / n,
                      "event_ms": None if d["device_ms"] is None
                      else d["device_ms"] / n,
                      "profiler_ms": by_span.get(k, 0.0) / n}
                  for k, d in s.items()}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    _, _, cell, _, _ = harness.setup(args.workload, "cuda", T_START)
    tracer = KeptTrace(cell.mix, cell.padded_pixels, cell.cfg.n_pixels)
    gc.collect()
    gc.freeze()
    loop.run_window(cell, args.seed, args.seconds, tracer)
    torch.cuda.synchronize()
    rec = tracer.record
    if program_spans.calls(rec) is None or tracer.events is None:
        print("crosscheck: the program recorded no spans to check")
        return 1
    line = dict(workload=args.workload, seed=args.seed,
                **crosscheck(rec, tracer.events))
    print("crosscheck " + json.dumps(line), flush=True)
    return 0 if line["host_ok"] and line["device_ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
