"""The port's spans: named intervals at the layer boundaries of the render
path, recorded exactly while a torch profiler records
(``torch.autograd._profiler_enabled()``): under the benchmark's traced
slice, ``chip_smoke.py`` or an operator's own ``torch.profiler.profile``.
There is no other switch.

A recorded span is a ``torch.profiler.record_function`` range named
``tpurt.<name>`` and a ``Span`` in a bounded in-memory buffer (its host
interval by ``time.perf_counter_ns``, its parent and the outermost span
around it, the call). In the profiler's trace each device operation sits
beside the range that launched it: that is where a span's device time is
read. A span given a CUDA ``device`` (``path.launch``: one kernel launch)
also records a pair of timing events on that device's current stream, the
start as the last thing before its body, so that code without the trace
can read the launch's device time; the pair comes from a fixed ring and
stays readable until the ring comes round. Nothing synchronizes; read the
events after synchronizing. Off, ``span`` costs one check and returns a
shared null context.

The spans of the render path (``render.py`` and the path launchers):
``render`` (a ``render`` or ``render_step`` call), ``render.check``,
``render.to_planes``, ``path.prepare`` (a launcher from its entry to the
launch call; the regen launcher's checks and its arguments are two) and
``path.launch`` (each launch, or on a CPU state the plain integrator in its
place), ``render.from_planes`` and ``until.welford`` (``render_until``'s
host sum of a batch). Spans nest as the calls of one thread do: the port
renders from one.

    from torch.profiler import profile
    with profile():
        state = tt.render_step(scene, cfg, cam, state, seed)
    torch.cuda.synchronize()
    print(tracing.summary(tracing.spans()))
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import itertools
import time

import torch

LIMIT = 65536   # spans kept; the oldest leave first
PAIRS = 1024    # timing event pairs per device, reused in turn
PREFIX = "tpurt."

_records: collections.deque = collections.deque()
_ids = itertools.count()
_open: list = []        # the spans open now, innermost last
_rings: dict = {}       # device index -> _Ring
_NULL = contextlib.nullcontext()


@dataclasses.dataclass
class Span:
    """One recorded span. ``events``: the (start, end) CUDA events around
    its body, or None (no device given, a CPU state, or the pair reused
    since)."""
    name: str
    id: int                     # unique in the process, in opening order
    parent: int | None          # the span open around it
    call: int                   # the outermost span open around it (or itself)
    t0_ns: int                  # host clock at entry
    t1_ns: int | None = None    # host clock at exit; None while open
    events: tuple | None = None

    @property
    def host_ms(self) -> float:
        return (self.t1_ns - self.t0_ns) * 1e-6

    def device_ms(self) -> float | None:
        """Device ms between its events, or None without events."""
        if self.events is None:
            return None
        return self.events[0].elapsed_time(self.events[1])


class _Ring:
    """``PAIRS`` event pairs of one device, made as first needed; taking
    a pair takes it from the span that held it."""

    def __init__(self):
        self.pairs, self.owners, self.next = [], [], 0

    def take(self, s: Span) -> tuple:
        if len(self.pairs) < PAIRS:
            self.pairs.append((torch.cuda.Event(enable_timing=True),
                               torch.cuda.Event(enable_timing=True)))
            self.owners.append(s)
            return self.pairs[-1]
        i = self.next
        self.next = (i + 1) % PAIRS
        self.owners[i].events = None
        self.owners[i] = s
        return self.pairs[i]


def span(name: str, device=None):
    """A context manager recording the span ``name`` while a torch
    profiler records, else a shared null context. ``device``: None or the
    ``torch.device`` whose current stream takes the span's work; on a
    CUDA device two events time the span's body there."""
    if not torch.autograd._profiler_enabled():
        return _NULL
    return _Recording(name, device)


class _Recording:
    __slots__ = ("name", "stream", "span", "range")

    def __init__(self, name: str, device):
        self.name = name
        self.stream = torch.cuda.current_stream(device) \
            if device is not None and device.type == "cuda" else None

    def __enter__(self) -> Span:
        sid = next(_ids)
        up = _open[-1] if _open else None
        s = Span(self.name, sid, None if up is None else up.id,
                 sid if up is None else up.call, time.perf_counter_ns())
        if len(_records) >= LIMIT:
            _records.popleft()
        _records.append(s)
        _open.append(s)
        self.span = s
        self.range = torch.profiler.record_function(PREFIX + self.name)
        self.range.__enter__()
        if self.stream is not None:
            ring = _rings.setdefault(self.stream.device_index, _Ring())
            s.events = ring.take(s)
            s.events[0].record(self.stream)
        return s

    def __exit__(self, *exc) -> bool:
        s = self.span
        if s.events is not None:
            s.events[1].record(self.stream)
        self.range.__exit__(*exc)
        _open.pop()
        s.t1_ns = time.perf_counter_ns()
        return False


def spans() -> list:
    """The recorded spans in the order they opened."""
    return list(_records)


def clear() -> None:
    """Empty the buffer."""
    _records.clear()


def summary(spans) -> dict:
    """Per span name over the closed spans given: ``count``, ``host_ms``,
    ``self_host_ms`` (host ms less what its child spans cover) and
    ``device_ms`` (by events; None where no span of the name has them).
    Times are sums. Device times need the events complete: synchronize
    first."""
    done = [s for s in spans if s.t1_ns is not None]
    child_ms = collections.Counter()
    for s in done:
        if s.parent is not None:
            child_ms[s.parent] += s.host_ms
    out = {}
    for s in done:
        d = out.setdefault(s.name, {"count": 0, "host_ms": 0.0,
                                    "self_host_ms": 0.0, "device_ms": None})
        d["count"] += 1
        d["host_ms"] += s.host_ms
        d["self_host_ms"] += s.host_ms - child_ms[s.id]
        if s.events is not None:
            d["device_ms"] = (d["device_ms"] or 0.0) + s.device_ms()
    return out
