"""path_kernel_roofline: the least time the H100 could take for the work
of the slice's render calls (``bench_torch/roofline.py``'s
``path_bound``, the bound of ``path_roofline``) as a share of the device
time of the program's ``path.launch`` spans (the kernel alone), in
percent."""

from bench_torch import program_spans


def read(rec: dict):
    got = program_spans.summary(rec)
    if got is None or rec.get("path_bound_ms", 0.0) <= 0.0:
        return None
    ms = got[0]["path.launch"]["device_ms"]
    return rec["path_bound_ms"] / ms * 100.0 if ms > 0.0 else None
