"""Readings that the limits in ``limits/<workload>.json`` are set from, on
the card, at the cell's own size and load:

    python3 bench_torch/control.py --workload <cell> --seconds <s> \\
        --seeds <n> <n> ...

For each seed, in one process (one set-up): a window of the program, the
numbers its check compares (the lower readings come from such sound runs),
then the control: the plain reference computed in bfloat16, the precision
below the configurations' float32, put in the program's place for the
same pixels and jobs (the upper readings). One JSON line per seed.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

from bench_torch import check, harness, loop  # noqa: E402


def readings(cell, seed: int, seconds: float, device: str) -> dict:
    """The program's numbers and the control's for one seed."""
    if cell.mix["state"] == "job":
        cell.check_pixels = check.job_pixels(cell, seed).to(device)
    jobs, t0, t1, state, host = loop.run_window(cell, seed, seconds)
    prog = check.program_outputs(cell, jobs, state, host, seed)
    n_jobs = len(jobs)
    del jobs, state, host
    want = check.reference_outputs(cell.config, prog, device)
    ctrl = check.reference_outputs(cell.config, prog, device,
                                   torch.bfloat16)
    return {"seed": seed, "jobs": n_jobs,
            "program": check.compare(prog, want),
            "control": check.compare(ctrl, want)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    _, _, cell, limits, _ = harness.setup(args.workload, "cuda", T_START)
    harness.log(f"device: {torch.cuda.get_device_name(0)}; "
                f"{harness.gpu_line()}")
    for seed in args.seeds:
        out = readings(cell, seed, args.seconds, "cuda")
        out["limits"] = limits
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
