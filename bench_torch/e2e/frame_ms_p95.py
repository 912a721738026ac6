"""frame_ms_p95: the 95th percentile (linear between ranks) of every
frame's milliseconds in the window, a frame from entering the render call
to its image in host memory."""

import numpy as np


def read(run: dict):
    return float(np.percentile(run["job_ms"], 95))
