"""Performance counters and traces: the DP fill rate in GCUPS (giga cell
updates per second, cells = sum |ref| * |read|), on-demand
``torch.profiler`` chrome traces, and the port's own tracer.

The tracer keeps everything in memory and is off until :func:`enable`:

- :func:`span` marks a layer of the program: a name, start and end on
  ``time.perf_counter()``, the span open around it on the same thread
  (its parent), the id of its input file (a ``file`` span takes a new
  one, every span inside it inherits it) and keyword attributes.  Off,
  it returns one shared null object and reads no clock.
- ``ops.cuda_score`` records every launch of the kernel library through
  :meth:`Tracer.launch`: two timing events on the launch's stream around
  the C entry call, the host time before it, its device and the
  innermost open span.  Nothing synchronises while the program runs.
- :func:`records`, called once the cards are synchronised, returns the
  spans and the launches, each launch placed on the host clock through
  two anchors of its card (:class:`Anchor`): one taken when tracing
  first saw the card and one taken then.

The program opens ``file`` (one input file of ``run_pipeline``),
``parse`` (the reads, each reference file), ``flush`` (one scoring
flush: ``cells``, those K1 scores in its 16-bit form ``cells_s16x2``,
``refs``, ``ref_bp``), ``encode`` (a flush's reference encoding, and its
split over the cards), ``wait`` (the host blocked on a card: ``on=``
``throttle``, ``upload``, ``resolve`` or ``readback``), ``traceback``
(one winner, ``branch=`` ``windowed`` or ``full``) and ``report`` (the
report and the journal).
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import math
import os
import threading
import time
from typing import Dict, Iterator, List, Optional, Tuple


@dataclasses.dataclass
class GcupsCounter:
    """Accumulates DP cells and elapsed seconds across dispatches."""

    cells: int = 0
    seconds: float = 0.0
    calls: int = 0

    def add(self, cells: int, seconds: float) -> None:
        self.cells += cells
        self.seconds += seconds
        self.calls += 1

    @contextlib.contextmanager
    def measure(self, cells: int) -> Iterator[None]:
        """Time the block as ``cells`` DP cells (no device synchronise)."""
        t0 = time.perf_counter()
        yield
        self.add(cells, time.perf_counter() - t0)

    @contextlib.contextmanager
    def measure_lazy(self):
        """Time the block; its cell count is given at the end:
        ``with counter.measure_lazy() as done: ...; done(cells)``."""
        t0 = time.perf_counter()
        holder = {"cells": 0}
        yield lambda cells: holder.__setitem__("cells", cells)
        self.add(holder["cells"], time.perf_counter() - t0)

    @property
    def gcups(self) -> float:
        return self.cells / self.seconds / 1e9 if self.seconds else 0.0

    def report(self) -> str:
        return (
            f"{self.cells:,} cells in {self.seconds:.3f}s over "
            f"{self.calls} calls = {self.gcups:.2f} GCUPS"
        )


@contextlib.contextmanager
def profiler_trace(log_dir: Optional[str], device="cuda") -> Iterator[None]:
    """A ``torch.profiler`` chrome trace of the block in
    ``log_dir/trace.json``, with CUDA activity when ``device`` is a CUDA
    device; a no-op when ``log_dir`` is falsy, so call sites can be
    unconditional."""
    if not log_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


# -- the tracer ---------------------------------------------------------------------

# Attributes that name a span's kind in its label ("wait:upload").
_KIND_ATTRS = ("on", "branch")


class Span:
    """One span of the program, a context manager; :meth:`set` adds
    attributes known only inside it (a flush's cells)."""

    __slots__ = ("name", "attrs", "parent", "file", "start", "end", "_tracer")

    def __init__(self, tracer: "Tracer", name: str, attrs: dict):
        self._tracer = tracer
        self.name = name
        self.attrs = attrs
        self.parent: Optional[Span] = None
        self.file: Optional[int] = None
        self.start = self.end = math.nan

    def __enter__(self) -> "Span":
        stack = self._tracer._stack()
        self.parent = stack[-1] if stack else None
        if self.name == "file":
            self.file = next(self._tracer._file_ids)
        elif self.parent is not None:
            self.file = self.parent.file
        stack.append(self)
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        self.end = time.perf_counter()
        self._tracer._stack().pop()
        self._tracer.spans.append(self)

    def set(self, **attrs) -> None:
        self.attrs.update(attrs)

    @property
    def label(self) -> str:
        """The name, with the ``on`` or ``branch`` attribute where it has one."""
        kind = next((self.attrs[k] for k in _KIND_ATTRS if k in self.attrs), None)
        return self.name if kind is None else f"{self.name}:{kind}"

    def __repr__(self) -> str:
        return f"Span({self.label!r}, {self.start:.6f}-{self.end:.6f}, file={self.file})"


class _NullSpan:
    """What :func:`span` returns while the tracer is off: it does nothing,
    and is false, so ``if s:`` skips work done only for a trace."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> None:
        return None

    def set(self, **attrs) -> None:
        return None

    def __bool__(self) -> bool:
        return False


NULL_SPAN = _NullSpan()


@dataclasses.dataclass
class Launch:
    """One launch of the kernel library: its C entry, device index, the
    host time just before the call and the innermost span open then;
    ``start`` and ``end`` are its two events placed on the host clock by
    :func:`records` (NaN before)."""

    entry: str
    device: int
    host_t: float
    span: Optional[Span]
    events: tuple
    start: float = math.nan
    end: float = math.nan


@dataclasses.dataclass
class Anchor:
    """A timing event recorded on an idle stream of a card, and the host
    time it stands for: the midpoint of ``perf_counter()`` before the
    record and after the event's ``synchronize()``."""

    event: object
    host_t: float


@dataclasses.dataclass
class Records:
    """What the tracer holds: spans in the order they ended, launches in
    the order they were made, and per card the drift of its anchors: the
    host's seconds between them less the card's."""

    spans: List[Span]
    launches: List[Launch]
    drift: Dict[int, float]


def on_host(first: Anchor, last: Anchor, card_between_s: float, card_s: float) -> float:
    """The host time of a card event ``card_s`` seconds after ``first``'s
    event, on the line through the two anchors (``card_between_s``: the
    card's seconds from ``first``'s event to ``last``'s)."""
    scale = (last.host_t - first.host_t) / card_between_s if card_between_s > 0 else 1.0
    return first.host_t + card_s * scale


class Tracer:
    """Spans and launches of one process; :data:`TRACER` is the one the
    program records into."""

    def __init__(self):
        self.on = False
        self.spans: List[Span] = []
        self.launches: List[Launch] = []
        self.anchors: Dict[int, Anchor] = {}
        self._local = threading.local()
        self._file_ids = itertools.count()
        self._streams: dict = {}

    def _stack(self) -> List[Span]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def reset(self) -> None:
        """Forget every record and anchor; spans still open stay open."""
        self.spans, self.launches, self.anchors = [], [], {}

    def anchor(self, device: int) -> Anchor:
        """A new anchor of ``device``, on a stream of its own that nothing
        else uses."""
        import torch

        stream = self._streams.get(device)
        if stream is None:
            stream = self._streams[device] = torch.cuda.Stream(device=device)
        event = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        event.record(stream)
        event.synchronize()
        t1 = time.perf_counter()
        return Anchor(event, (t0 + t1) / 2)

    @contextlib.contextmanager
    def launch(self, entry: str, device: int, handle: int) -> Iterator[None]:
        """Record the launch the block makes: timing events before and
        after it on stream ``handle`` of ``device``."""
        import torch

        stream = torch.cuda.current_stream(device)
        if stream.cuda_stream != (handle or 0):
            stream = torch.cuda.ExternalStream(handle, device=device)
        if device not in self.anchors:
            self.anchors[device] = self.anchor(device)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        stack = self._stack()
        host_t = time.perf_counter()
        start.record(stream)
        try:
            yield
        finally:
            end.record(stream)
            self.launches.append(Launch(entry, device, host_t, stack[-1] if stack else None, (start, end)))

    def records(self) -> Records:
        """Spans and launches so far, each launch placed on the host clock;
        call it once every card is synchronised.  Takes a second anchor of
        each card the launches used."""
        drift = {}
        for device, first in self.anchors.items():
            last = self.anchor(device)
            card_between_s = first.event.elapsed_time(last.event) / 1e3
            drift[device] = (last.host_t - first.host_t) - card_between_s
            for x in self.launches:
                if x.device == device:
                    x.start, x.end = (on_host(first, last, card_between_s, first.event.elapsed_time(e) / 1e3)
                                      for e in x.events)
        return Records(list(self.spans), list(self.launches), drift)


TRACER = Tracer()


def enable() -> None:
    """Switch the tracer on; what it holds is kept (:func:`reset`)."""
    TRACER.on = True


def disable() -> None:
    TRACER.on = False


def tracing() -> bool:
    return TRACER.on


def reset() -> None:
    TRACER.reset()


def span(name: str, **attrs):
    """Span ``name`` of the program while the tracer is on, else
    :data:`NULL_SPAN`."""
    return Span(TRACER, name, attrs) if TRACER.on else NULL_SPAN


def records() -> Records:
    return TRACER.records()


def self_pieces(spans: List[Span]) -> List[Tuple[float, float, Span]]:
    """(start, end, span) of each stretch of time in which ``span`` is the
    innermost of ``spans`` open: its interval less its children's.  A
    span's self time is the sum of its pieces."""
    children: Dict[int, List[Span]] = {}
    for s in spans:
        children.setdefault(id(s.parent), []).append(s)
    pieces = []
    for s in spans:
        t = s.start
        for child in sorted(children.get(id(s), ()), key=lambda c: c.start):
            if child.start > t:
                pieces.append((t, child.start, s))
            t = max(t, child.end)
        if s.end > t:
            pieces.append((t, s.end, s))
    return pieces
