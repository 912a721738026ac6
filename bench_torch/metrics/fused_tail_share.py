"""fused_tail_share: the share of the fused wavefront kernel's path
segments that its tail instance traced in tails
(``tpurt_torch.kernels.wavefront_fused.tail_share``: tail segments over
all path segments of the instance's launches in the run's process,
set-up's included), in percent. The tail instance runs the uniform
launches of several samples a pixel (``mega_regen.TAIL_MIN_SPP`` or
more) under the reference sampler without switches
(``wavefront_fused.tail_engages``); once at most a few lanes of a warp are
on a path, the others start their next sample, and the segments the
stragglers trace from then on are tail segments. None on a program
without the counter, or where no launch ran the instance."""


def read(rec: dict):
    try:
        from tpurt_torch.kernels import wavefront_fused
    except ImportError:
        return None
    share = getattr(wavefront_fused, "tail_share", None)
    if share is None:
        return None
    value = share()
    return None if value is None else value * 100.0
