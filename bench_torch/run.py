"""Run one cell of the port's benchmark once, on the CUDA card:

    python3 bench_torch/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout. The last line of standard output is the
result (JSON); the numbers compared for ``correct`` end standard error. It
exits 3, printing no result, without a CUDA card or with fewer than the
cell asks for.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

from bench_torch import harness  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        out = harness.run(args.workload, args.seed, args.seconds,
                          bool(args.trace), T_START)
    except harness.NoDevice as e:
        print(f"no measurement: {e}", file=sys.stderr)
        return 3
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
