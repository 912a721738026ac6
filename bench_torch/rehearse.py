"""Rehearse every cell on the CPU, without a card:

    python3 bench_torch/rehearse.py [--seconds 1] [--workload NAME ...]

Each cell's job loop, its traced slice with the span recording, each
metric's reader and the check against the plain reference run at 64x32
(depth 4; the torus with 256 triangles) through the port's plain
PyTorch paths. Every device number is
printed as "not measured": a CPU run measures no device. The measured
command, ``run.py``, refuses to run without a card.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

from bench_torch import harness  # noqa: E402

# 64x32 at depth 4, the torus at 16x8 segments (256 triangles: the plain
# sweep pads a frame to 4096 lanes), traced slices of two jobs
SHRINK = {"size": (64, 32, 4), "mix": {"trace": {"skip_jobs": 1, "jobs": 2}}}
SCENE = {"torus_mesh_scene": {"nu": 16, "nv": 8}}
SEED = 3000000019


def shrink(workload: str) -> dict:
    _, _, config, _, _ = harness.load(workload)
    return dict(SHRINK, args=SCENE.get(config["scene"]["builder"], {}))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--workload", nargs="*")
    args = ap.parse_args(argv)
    bench = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    names = args.workload or [w["name"] for w in bench["workloads"]]
    ok = True
    for name in names:
        for traced in (False, True):
            t0 = time.perf_counter()
            out = harness.run(name, SEED, args.seconds, traced, t0,
                              device="cpu", shrink=shrink(name))
            shown = {k: ("not measured" if k in ("memory_peak_bytes",)
                         else v) for k, v in out["device"].items()}
            print(f"{name} trace={int(traced)} correct={out['correct']} "
                  f"jobs={out['attempted']} device={shown} "
                  f"checks={out['checks']}", flush=True)
            for k in out["metrics"]:
                print(f"  {k}: not measured (a CPU rehearsal)")
            ok &= out["correct"]
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
