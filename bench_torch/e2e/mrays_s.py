"""mrays_s: millions of traced segments per second of the window: every
segment that ``RenderState.rays`` counted in the window's jobs (whole jobs
only) over the window's wall time, from its first job's start to its last
job's image on the host."""


def read(run: dict):
    return run["segments"] / run["window_s"] / 1e6
