"""driver_host_ms: mean host milliseconds a frame spends inside the
``render`` span (the frame's ``render_step``), where the render driver
(``tpurt_torch/render.py``) checks the call, turns the state into planes
and back and enqueues the launch (the call is asynchronous: this is host
time, not device time)."""


def read(rec: dict):
    d = rec["spans"].get("render")
    if not d or not d["count"]:
        return None
    return d["host_s"] / d["count"] * 1e3
