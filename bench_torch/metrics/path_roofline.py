"""path_roofline: the least time the H100 could take for the work the
``render`` spans (the job's render call) did (``bench_torch/roofline.py``:
each launch's planes read and written once, 300 float32 operations a
traced segment, against 3.35 TB/s and 67 TFLOP/s at the full 700 W), as a
share of the device time of everything launched inside those spans, in
percent."""


def read(rec: dict):
    if not rec["complete"]:
        return None
    dev = rec["spans"].get("render", {}).get("device_s", 0.0)
    if dev <= 0.0 or rec["path_bound_ms"] <= 0.0:
        return None
    return rec["path_bound_ms"] * 1e-3 / dev * 100.0
