"""Run one cell several times, one process a run, and report each metric's
spread (the bounds in BENCHMARK.json are set from it):

    python3 bench_torch/spread.py --workload <cell> --seconds <s> \\
        --seeds <n> <n> ... [--trace 1] [--out runs.jsonl]

A spread is the distance between the first and the third quartile
(``statistics.quantiles(values, n=4)``) as a share of the median. Each run's
result line is appended to ``--out`` with its seed; ``--summary`` reads such
files back instead of running.
"""

import argparse
import json
import pathlib
import statistics
import subprocess
import sys

HERE = pathlib.Path(__file__).resolve().parent


def spread(values: list) -> dict:
    med = statistics.median(values)
    q1, _, q3 = statistics.quantiles(values, n=4)
    return {"median": med, "q1": q1, "q3": q3,
            "spread": (q3 - q1) / med if med else float("nan"),
            "n": len(values)}


def summarize(lines: list) -> dict:
    by = {}
    for ln in lines:
        for k, v in ln["result"]["metrics"].items():
            by.setdefault((ln["workload"], k), []).append(v["value"])
    return {f"{w} {k}": spread(v) for (w, k), v in by.items() if len(v) > 1}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload")
    ap.add_argument("--seconds", type=float)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--out")
    ap.add_argument("--summary", nargs="*")
    args = ap.parse_args(argv)
    lines = []
    if args.summary:
        for f in args.summary:
            lines += [json.loads(x) for x in open(f) if x.strip()]
    for seed in args.seeds:
        p = subprocess.run(
            [sys.executable, str(HERE / "run.py"), "--workload",
             args.workload, "--seed", str(seed), "--seconds",
             str(args.seconds), "--trace", str(args.trace)],
            capture_output=True, text=True)
        err = p.stderr.strip().splitlines()
        try:
            result = json.loads(p.stdout.strip().splitlines()[-1])
        except (IndexError, json.JSONDecodeError):
            print(f"{args.workload} seed {seed}: exit {p.returncode}, no "
                  f"result\n" + "\n".join(err[-30:]), flush=True)
            continue
        ln = {"workload": args.workload, "seed": seed, "trace": args.trace,
              "rc": p.returncode, "result": result,
              "log": [x for x in err
                      if x.startswith(("window", "trace", "setup s"))]}
        lines.append(ln)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(ln) + "\n")
        m = {k: round(v["value"], 4) for k, v in result["metrics"].items()}
        print(f"{args.workload} seed {seed} correct {result['correct']} "
              f"{m} {ln['log']}", flush=True)
    for k, s in summarize(lines).items():
        print(f"{k}: median {s['median']:.6g} q1 {s['q1']:.6g} q3 "
              f"{s['q3']:.6g} spread {s['spread']:.5f} (n {s['n']})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
