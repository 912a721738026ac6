"""path_device_ms: device milliseconds per sample of everything launched
inside the ``render`` spans (the job's render call): the path kernel and
the driver's plane passes, copies and fills."""


def read(rec: dict):
    if not rec["complete"] or not rec["samples"]:
        return None
    dev = rec["spans"].get("render", {}).get("device_s", 0.0)
    if dev <= 0.0:
        return None
    return dev / rec["samples"] * 1e3
