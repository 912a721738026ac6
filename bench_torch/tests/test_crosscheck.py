"""``crosscheck.py``'s reduction of a chrome trace, on a trace made by
hand: each device operation goes to the innermost ``tpurt.*`` span open
at its launch, within its ``render`` call, and the device's idle time to
the innermost range the host was in meanwhile."""

import pytest

from bench_torch import crosscheck

# one render call: the planes' op launched at 12 runs in [15, 25], the
# kernel launched at 55 runs in [70, 170]
EVENTS = [
    {"ph": "X", "cat": "user_annotation", "name": "bench.render",
     "ts": 0, "dur": 100},
    {"ph": "X", "cat": "user_annotation", "name": "tpurt.render",
     "ts": 0, "dur": 100},
    {"ph": "X", "cat": "user_annotation", "name": "tpurt.render.to_planes",
     "ts": 10, "dur": 10},
    {"ph": "X", "cat": "user_annotation", "name": "tpurt.path.launch",
     "ts": 50, "dur": 10},
    {"ph": "X", "cat": "cpu_op", "name": "aten::cat", "ts": 11, "dur": 3},
    {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
     "ts": 12, "dur": 1, "args": {"correlation": 1}},
    {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
     "ts": 55, "dur": 1, "args": {"correlation": 2}},
    {"ph": "X", "cat": "kernel", "name": "cat_kernel", "ts": 15, "dur": 10,
     "args": {"correlation": 1}},
    {"ph": "X", "cat": "kernel", "name": "regen_kernel", "ts": 70,
     "dur": 100, "args": {"correlation": 2}},
]


def test_ops_go_to_the_innermost_span():
    ranges, ops = crosscheck.ranges_and_ops(EVENTS)
    assert [r[2] for r in ranges] == ["bench.render", "tpurt.render",
                                      "tpurt.render.to_planes",
                                      "tpurt.path.launch"]
    calls, prog = crosscheck.program_ops(ranges, ops)
    assert calls == [(0.0, 100.0, "tpurt.render")]
    assert prog == [(0, "render.to_planes", 15.0, 25.0),
                    (0, "path.launch", 70.0, 170.0)]


def test_idle_goes_to_the_host_span_meanwhile():
    ranges, ops = crosscheck.ranges_and_ops(EVENTS)
    idle = crosscheck.idle_by_host_span(ranges, ops, 0.0, 100.0)
    assert idle == pytest.approx({"tpurt.render": 0.045,
                                  "tpurt.render.to_planes": 0.005,
                                  "tpurt.path.launch": 0.010})


def test_quantiles_by_nearest_rank():
    q = crosscheck.quantiles([float(v) for v in range(1, 11)])
    assert (q["median"], q["p90"], q["max"]) == (5.0, 9.0, 10.0)
    assert q["over_2x_median"] == 0
