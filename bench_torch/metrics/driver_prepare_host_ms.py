"""driver_prepare_host_ms: mean host milliseconds a call spends in the
program's ``path.prepare`` spans: in a path launcher from its entry to the
launch call (the frozen scene, the parameter table with the camera rows,
the switch structs, the kernel library, the launch counters and the
arguments)."""

from bench_torch import program_spans


def read(rec: dict):
    got = program_spans.summary(rec)
    if got is None or "path.prepare" not in got[0]:
        return None
    s, n = got
    return s["path.prepare"]["host_ms"] / n
