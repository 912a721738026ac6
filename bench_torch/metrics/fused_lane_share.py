"""fused_lane_share: the share of the fused wavefront kernel's warp trips'
lanes that traced a segment (``tpurt_torch.kernels.wavefront_fused.
lane_share``: lanes over 32 times the trips, summed over every fused
launch of the run's process, set-up's included), in percent. Its uniform
launches keep a warp's lanes in lockstep, so a lane whose path ended waits
for the warp's longest. None on a program without the counter, or where no
fused launch ran."""


def read(rec: dict):
    try:
        from tpurt_torch.kernels import wavefront_fused
    except ImportError:
        return None
    share = getattr(wavefront_fused, "lane_share", None)
    if share is None:
        return None
    value = share()
    return None if value is None else value * 100.0
