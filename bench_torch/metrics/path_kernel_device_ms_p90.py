"""path_kernel_device_ms_p90: the 90th percentile (nearest rank: a tenth
of the calls, rounded down, lie above it) over the slice's calls of one
call's device milliseconds in the program's ``path.launch`` spans, by CUDA
events: a tail here is the kernel's, not the host's."""

import math

from bench_torch import program_spans


def read(rec: dict):
    calls = program_spans.calls(rec)
    if calls is None:
        return None
    ms = sorted(sum(s.device_ms() for s in c if s.name == "path.launch")
                for c in calls)
    return ms[math.ceil(0.9 * len(ms)) - 1]
