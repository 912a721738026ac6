"""blit_device_ms: device milliseconds per frame of everything launched
inside the ``resolve_image`` spans (the blit kernel,
``tpurt_torch/kernels/tonemap.py`` and ``csrc/tonemap.cu``)."""


def read(rec: dict):
    d = rec["spans"].get("resolve_image")
    if not rec["complete"] or not d or not d["count"] \
            or d["device_s"] <= 0.0:
        return None
    return d["device_s"] / d["count"] * 1e3
