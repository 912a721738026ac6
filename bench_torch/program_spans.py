"""The program's own spans (``tpurt_torch.tracing``) in a traced run's
final slice, for the readers whose source is ``program_span``.

The port records spans exactly while a torch profiler records, and the
traced run profiles nothing after its final slice: the slice's calls are
the last ``rec["frames"]`` top-level ``render`` spans the program recorded,
one a job.
"""

from __future__ import annotations

import torch

def calls(rec: dict):
    """One list of spans per ``render`` call of the slice, each its call's
    spans in opening order; or None: on a program without the recorder,
    without a card, where the program recorded fewer calls than the slice
    has jobs, or where a call has no launch with its CUDA events."""
    try:
        from tpurt_torch import tracing
    except ImportError:
        return None
    n = int(rec.get("frames") or 0)
    if n <= 0 or not torch.cuda.is_available():
        return None
    spans = tracing.spans()
    roots = [s for s in spans if s.name == "render" and s.parent is None]
    if len(roots) < n:
        return None
    by_call = {s.id: [] for s in roots[-n:]}
    for s in spans:
        if s.call in by_call:
            by_call[s.call].append(s)
    out = list(by_call.values())
    for c in out:
        launches = [s for s in c if s.name == "path.launch"]
        if not launches or any(s.events is None or s.t1_ns is None
                               for s in launches):
            return None
    return out


def summary(rec: dict):
    """(``tracing.summary`` of the slice's calls, the number of calls), or
    None where ``calls`` finds none."""
    got = calls(rec)
    if got is None:
        return None
    from tpurt_torch import tracing
    return tracing.summary([s for c in got for s in c]), len(got)
