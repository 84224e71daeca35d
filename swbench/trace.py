"""What a traced run records, from the benchmark's own wrappers.

- Host spans: each declared target (``"module:attr"`` or
  ``"module:Class.attr"``) is wrapped from outside, as
  ``utils/profile_scale.py`` wraps the port's layers, and each call is
  kept as (span, start, end, value) on the host clock; ``value`` is what a
  reader's value function makes of the call, such as a flush's real cells.
- Device time: every C entry of the kernel library that launches work is
  bracketed by two CUDA events on the stream the entry is given, with no
  spin kernel, so an event pair holds the launch and any wait of the
  stream on the host.  Each launch keeps its entry, device, integer
  arguments, host time and the innermost span open when it was made.

Everything stays in memory; :meth:`Trace.close` synchronises the cards
once the window has ended and reads the events.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import importlib
import time
from typing import Callable, Dict, List, Optional, Tuple


@dataclasses.dataclass
class Launch:
    entry: str
    device: int
    host_t: float
    args: tuple
    label: str
    start: object = None
    end: object = None
    ms: float = 0.0


def launch_entries(lib) -> List[str]:
    """The library's C entries that launch on a stream: those whose last
    two arguments are the device and the stream."""
    names = []
    for name, fn in vars(lib).items():
        argtypes = getattr(fn, "argtypes", None)
        if name.startswith("swt_") and argtypes and len(argtypes) >= 2 \
                and argtypes[-2] is ctypes.c_int and argtypes[-1] is ctypes.c_void_p:
            names.append(name)
    return sorted(names)


def _resolve(target: str):
    """(owner, attribute) of ``"module:attr"`` or ``"module:Class.attr"``."""
    module, _, path = target.partition(":")
    owner = importlib.import_module(module)
    *outer, attr = path.split(".")
    for name in outer:
        owner = getattr(owner, name)
    return owner, attr


class Trace:
    """Spans and launches of one traced run."""

    def __init__(self):
        self.spans: List[Tuple[str, float, float, object]] = []
        self.launches: List[Launch] = []
        self.notes: List[str] = []
        self.window = (0.0, 0.0)
        self.cards = 1
        self.sms = 0
        self.clock_mhz = 0.0
        self._stack: List[str] = []
        self._undo: List[Callable[[], None]] = []
        self._wrapped: Dict[str, str] = {}

    # -- recording ----------------------------------------------------------

    def span(self, name: str, target: str, value: Optional[Callable] = None) -> None:
        """Record every call of ``target`` as span ``name``."""
        if self._wrapped.get(target, name) != name:
            raise ValueError(f"{target} is already span {self._wrapped[target]!r}, not {name!r}")
        if target in self._wrapped:
            return
        owner, attr = _resolve(target)
        fn = owner.__dict__[attr] if isinstance(owner, type) else getattr(owner, attr)

        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            self._stack.append(name)
            t0 = time.perf_counter()
            try:
                out = fn(*args, **kwargs)
            finally:
                t1 = time.perf_counter()
                self._stack.pop()
            self.spans.append((name, t0, t1, value(args, kwargs, out) if value else None))
            return out

        setattr(owner, attr, wrapped)
        self._wrapped[target] = name
        self._undo.append(lambda: setattr(owner, attr, fn))

    def open(self, name: str):
        """A span the harness opens itself, as a context manager."""
        trace = self

        class _Span:
            def __enter__(self):
                trace._stack.append(name)
                self.t0 = time.perf_counter()

            def __exit__(self, *exc):
                trace._stack.pop()
                trace.spans.append((name, self.t0, time.perf_counter(), None))

        return _Span()

    def bracket(self, lib, names: List[str]) -> None:
        """Bracket each C entry in ``names`` by CUDA events on its stream."""
        import torch

        for name in names:
            entry = getattr(lib, name)

            def call(*args, _name=name, _entry=entry):
                device, handle = args[-2], args[-1]
                stream = torch.cuda.current_stream(device)
                if stream.cuda_stream != (handle or 0):
                    stream = torch.cuda.ExternalStream(handle, device=device)
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                label = self._stack[-1] if self._stack else "harness"
                host_t = time.perf_counter()
                start.record(stream)
                rc = _entry(*args)
                end.record(stream)
                self.launches.append(Launch(_name, int(device), host_t, tuple(args), label, start, end))
                return rc

            setattr(lib, name, call)
            self._undo.append(lambda _name=name, _entry=entry: setattr(lib, _name, _entry))

    def reset(self) -> None:
        self.spans.clear()
        self.launches.clear()

    def remove(self) -> None:
        """Undo every wrapper."""
        while self._undo:
            self._undo.pop()()

    def close(self, t0: float, t1: float, devices) -> None:
        """End the window at [t0, t1] on the host clock; wait for the cards
        and read every event."""
        import torch

        self.window = (t0, t1)
        for d in devices:
            torch.cuda.synchronize(d)
        self.launches = [x for x in self.launches if t0 <= x.host_t <= t1]
        for x in self.launches:
            x.ms = x.start.elapsed_time(x.end)

    # -- reading ------------------------------------------------------------

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def spans_named(self, name: str) -> List[Tuple[float, float, object]]:
        """Spans ``name`` inside the window, clipped to it."""
        t0, t1 = self.window
        return [(max(a, t0), min(b, t1), v) for n, a, b, v in self.spans if n == name and b > t0 and a < t1]

    def span_seconds(self, name: str) -> float:
        return sum(b - a for a, b, _ in self.spans_named(name))

    def launches_of(self, entries=None) -> List[Launch]:
        return [x for x in self.launches if entries is None or x.entry in entries]

    def gaps(self) -> List[Tuple[str, float]]:
        """(label, seconds) of the device's idle gaps between consecutive
        bracketed launches on each card, labelled with the innermost span
        open on the host when the later launch was made."""
        out = []
        for d in sorted({x.device for x in self.launches}):
            seq = sorted((x for x in self.launches if x.device == d), key=lambda x: x.host_t)
            for a, b in zip(seq[:-1], seq[1:]):
                out.append((b.label, max(0.0, a.end.elapsed_time(b.start)) / 1e3))
        return out
