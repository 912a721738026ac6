"""idle_share: the share of the traced window's wall time in which no
device operation (kernel, copy or fill) ran, in percent."""


def read(rec: dict):
    if not rec["complete"] or rec["window_s"] <= 0.0:
        return None
    return (1.0 - rec["busy_s"] / rec["window_s"]) * 100.0
