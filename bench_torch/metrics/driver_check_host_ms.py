"""driver_check_host_ms: mean host milliseconds a call spends in the
program's ``render.check`` span (``render._check_call``: the config, the
camera, the state's size and the devices checked), its self time."""

from bench_torch import program_spans


def read(rec: dict):
    got = program_spans.summary(rec)
    if got is None or "render.check" not in got[0]:
        return None
    s, n = got
    return s["render.check"]["self_host_ms"] / n
