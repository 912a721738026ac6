"""path_kernel_device_ms: device milliseconds a sample in the program's
``path.launch`` spans (the path kernel's launches alone, without the plane
passes), by CUDA events."""

from bench_torch import program_spans


def read(rec: dict):
    got = program_spans.summary(rec)
    if got is None or not rec.get("samples"):
        return None
    return got[0]["path.launch"]["device_ms"] / rec["samples"]
