"""One run of one cell: set-up, the measured window, the check, the result
line. ``run.py`` is its command line; ``rehearse.py`` and the tests drive
it on the CPU.

Everything that belongs to one configuration, traffic mix or metric is a
file found by its name in ``BENCHMARK.json``: ``configs/<config>.json``,
``traffic/<traffic>.json``, ``limits/<workload>.json``, and a reader
``e2e/<metric>.py`` or ``metrics/<metric>.py`` with ``read(record)``,
which returns None where it finds nothing to read.
"""

from __future__ import annotations

import gc
import importlib
import json
import pathlib
import subprocess
import sys
import time

import torch

from bench_torch import check, loop, trace

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "tpurt", "bench", "chip_smoke", "chip_ab")


class NoDevice(RuntimeError):
    """The run cannot measure: no CUDA card, or fewer than the cell asks
    for."""


def load(workload: str) -> tuple:
    """(BENCHMARK.json, its cell, the cell's configuration, mix, limits)."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; "
                         f"known: {sorted(cells)}")
    cell = cells[workload]
    config = json.loads((HERE / "configs" / f"{cell['config']}.json")
                        .read_text())
    mix = json.loads((HERE / "traffic" / f"{cell['traffic']}.json")
                     .read_text())
    limits = json.loads((HERE / "limits" / f"{workload}.json").read_text())
    return bench, cell, config, mix, limits


def reader(kind: str, name: str):
    return importlib.import_module(f"bench_torch.{kind}.{name}").read


def applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def gpu_line() -> str:
    """The card's name and power limit as nvidia-smi reads them."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi not readable"


def import_port():
    """The port, after checking that nothing imported the JAX package."""
    import tpurt_torch
    bad = [m for m in FORBIDDEN if m in sys.modules]
    if bad:
        raise SystemExit(f"the benchmark imported {bad}: it measures "
                         f"tpurt_torch alone")
    return tpurt_torch


def log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def shrunk(config: dict, mix: dict, shrink: dict) -> tuple:
    """A rehearsal's configuration and mix: ``shrink`` may give ``size``
    (width, height, depth), scene ``args`` and mix keys."""
    if "size" in shrink:
        w, h, d = shrink["size"]
        config = dict(config, render=dict(config["render"], width=w,
                                          height=h, depth=d))
    if "args" in shrink:
        config = dict(config, scene=dict(config["scene"], args=dict(
            config["scene"]["args"], **shrink["args"])))
    return config, dict(mix, **shrink.get("mix", {}))


def setup(workload: str, device: str, t_start: float, shrink=None):
    """Everything before the window; returns (bench, entry, cell, limits,
    setup_s). ``shrink`` (see ``shrunk``) makes a rehearsal small. Logs
    where the set-up's time went."""
    stamps = [("imports", time.perf_counter())]
    bench, entry, config, mix, limits = load(workload)
    if device == "cuda":
        if not torch.cuda.is_available() \
                or torch.cuda.device_count() < int(entry["chips"]):
            raise NoDevice(
                f"{workload} needs {entry['chips']} CUDA card(s); "
                f"torch.cuda.is_available()={torch.cuda.is_available()}, "
                f"device_count={torch.cuda.device_count()}")
        torch.zeros(1, device=device)
    stamps.append(("context", time.perf_counter()))
    tt = import_port()
    stamps.append(("port", time.perf_counter()))
    if shrink:
        config, mix = shrunk(config, mix, shrink)
    cell = loop.Cell(tt, config, mix, device)
    stamps.append(("scene", time.perf_counter()))
    # one warm job of the cell's own shape, on a state of its own
    state = cell.fresh()
    cell.padded_pixels = state.rgb_sum.shape[0]
    loop.one_job(cell, state, loop.job_seed(0x5EED, 0))
    del state
    if device == "cuda":
        torch.cuda.synchronize()
    stamps.append(("warm job", time.perf_counter()))
    t = t_start
    parts = []
    for name, u in stamps:
        parts.append(f"{name} {u - t:.4f}")
        t = u
    log("setup s: " + ", ".join(parts))
    return bench, entry, cell, limits, t - t_start


def run(workload: str, seed: int, seconds: float, traced: bool,
        t_start: float, device: str = "cuda", shrink=None) -> dict:
    """One run; returns the result line's object (and logs to stderr).
    ``shrink`` makes a rehearsal small (``shrunk``)."""
    bench, entry, cell, limits, setup_s = setup(workload, device, t_start,
                                                shrink)
    on_card = device == "cuda"
    kind = torch.cuda.get_device_name(0) if on_card else "cpu"
    log(f"device: {kind}; {gpu_line() if on_card else 'no card'}; "
        f"workload {workload}, seed {seed}, {seconds} s, trace {int(traced)}")
    if cell.mix["state"] == "job":
        cell.check_pixels = check.job_pixels(cell, seed).to(device)
    tracer = trace.Tracer(cell.mix, cell.padded_pixels,
                          cell.cfg.n_pixels) if traced else None
    gc.collect()
    gc.freeze()     # set-up's objects leave the collector's young passes
    jobs, t0, t1, state, host = loop.run_window(cell, seed, seconds, tracer)
    if on_card:
        torch.cuda.synchronize()
    if cell.mix["state"] == "window":
        segments = int(state.rays)
    else:
        segments = sum(int(j.rays) for j in jobs)
    job_ms = [(j.t1 - j.t0) * 1e3 for j in jobs]
    peak = torch.cuda.max_memory_allocated() if on_card else None
    prog = check.program_outputs(cell, jobs, state, host, seed)
    config = cell.config
    n_jobs = len(jobs)
    del jobs, state, host, cell
    if on_card:
        torch.cuda.empty_cache()
    correct, checks, check_s = check.run_check(config, prog, device, limits)
    record = {"segments": segments, "window_s": t1 - t0, "job_ms": job_ms,
              "setup_s": setup_s, "jobs": n_jobs}
    q = sorted(job_ms)
    log(f"window: {n_jobs} jobs in {t1 - t0:.4f} s, {segments} segments; "
        f"job ms median {q[len(q) // 2]:.4f}, "
        f"p99 {q[len(q) * 99 // 100]:.4f}, "
        f"max {q[-1]:.4f}; setup "
        f"{setup_s:.4f} s; check {check_s:.4f} s on {len(prog['jobs'])} "
        f"job(s) x {len(prog['pixels'])} pixels")
    metrics = {}
    if not traced:
        for m in bench["end_to_end"]:
            if applies(m, workload):
                v = reader("e2e", m["name"])(record)
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        rec = tracer.record
        for a in tracer.attempts:
            log(f"trace slice jobs {a['slice']}: launches counted / "
                f"recorded: path {a['launches']['path']['counted']} / "
                f"{a['launches']['path']['recorded']}, blit "
                f"{a['launches']['blit']['counted']} / "
                f"{a['launches']['blit']['recorded']}")
        for m in bench["per_layer"]:
            if not applies(m, workload):
                continue
            v = reader("metrics", m["name"])(rec)
            if v is None or not on_card:
                log(f"{m['name']}: not measured")
            else:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu" if on_card else "cpu", "kind": kind,
           "count": int(entry["chips"]) if on_card else 0,
           "memory_peak_bytes": peak}
    out = {"correct": correct, "attempted": n_jobs, "failed": 0,
           "metrics": metrics, "device": dev}
    if traced:
        rec = tracer.record
        if on_card:
            dev["busy_s"] = rec["busy_s"]
            dev["window_s"] = rec["window_s"]
        out["breakdown"] = rec["breakdown"]
    out["checks"] = checks
    for k, c in checks.items():
        log(f"check {k} {c['value']!r} limit {c['limit']!r}")
    return out
