"""path_lane_share: the share of the regen kernel's pool instance's warp
trips' lanes that held a path (``tpurt_torch.kernels.mega_regen.
lane_share``: lanes over 32 times the trips, summed over every pool launch
of the run's process, set-up's included), in percent. The pool instance
runs the uniform launches of scenes without triangles under the reference
sampler (``mega_regen.pool_engages``). None on a program without the
counter, or where no launch ran the pool instance."""


def read(rec: dict):
    try:
        from tpurt_torch.kernels import mega_regen
    except ImportError:
        return None
    share = getattr(mega_regen, "lane_share", None)
    if share is None:
        return None
    value = share()
    return None if value is None else value * 100.0
