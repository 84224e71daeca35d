"""What the port's own tracer (``sparksmithwaterman_tpu_torch.utils.profiling``)
recorded in a traced run, read on the benchmark's window.

The readers that use it switch the tracer on when they are imported
(:func:`switch_on`).  ``spec.reader`` imports readers only in ``--trace 1``
runs, before the backend is made, so end-to-end runs keep it off.  The
program's spans and its launches, placed on the host clock by the
tracer's anchors, share the window's clock (``time.perf_counter``).  On
a tree without the tracer these readers return ``spec.ABSENT``; where a
run launched nothing on a card, they read nothing.

Intervals are (start, end) pairs of host seconds.
"""

from __future__ import annotations

import bisect
from typing import Dict, Iterable, List, Tuple

from swbench import spec

Interval = Tuple[float, float]


def _profiling():
    from sparksmithwaterman_tpu_torch.utils import profiling

    return profiling


def switch_on() -> None:
    """Switch the program's tracer on, where the program has one."""
    try:
        _profiling().enable()
    except (ImportError, AttributeError):
        pass


def records():
    """The program's records (``profiling.Records``) once the window has
    closed and the cards are synchronised (``Trace.close``); ``spec.ABSENT``
    where the program has no tracer, None where it recorded no launch."""
    try:
        rec = _profiling().records()
    except (ImportError, AttributeError):
        return spec.ABSENT
    return rec if rec.launches else None


def clip(intervals: Iterable[Interval], window: Interval) -> List[Interval]:
    t0, t1 = window
    return [(max(a, t0), min(b, t1)) for a, b in intervals if b > t0 and a < t1]


def union(intervals: Iterable[Interval]) -> List[Interval]:
    """Sorted, disjoint intervals covering the same time."""
    out: List[Interval] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        elif b > a:
            out.append((a, b))
    return out


def total(intervals: Iterable[Interval]) -> float:
    return sum(b - a for a, b in intervals)


def minus(a: List[Interval], b: List[Interval]) -> List[Interval]:
    """``a`` less ``b``, both sorted and disjoint (:func:`union`)."""
    out: List[Interval] = []
    k = 0
    for lo, hi in a:
        while k < len(b) and b[k][1] <= lo:
            k += 1
        j, t = k, lo
        while j < len(b) and b[j][0] < hi:
            if b[j][0] > t:
                out.append((t, b[j][0]))
            t = max(t, b[j][1])
            j += 1
        if t < hi:
            out.append((t, hi))
    return out


def spans(rec, name: str, window: Interval) -> List[Interval]:
    """The time inside the window covered by the program's spans ``name``."""
    return union(clip(((s.start, s.end) for s in rec.spans if s.name == name), window))


def idle(rec, device: int, window: Interval) -> List[Interval]:
    """The window less the launches of card ``device``, from each launch's
    first event to its second."""
    busy = union(clip(((x.start, x.end) for x in rec.launches if x.device == device), window))
    return minus([window], busy)


def attribute(gaps: List[Interval], rec) -> List[Dict[str, float]]:
    """Per gap, its seconds by the label of the program span whose self
    time covers them (``profiling.self_pieces``); ``(no span)`` for what
    no span covers."""
    pieces = sorted(_profiling().self_pieces(rec.spans), key=lambda p: p[0])
    starts = [p[0] for p in pieces]
    out = []
    for lo, hi in gaps:
        by: Dict[str, float] = {}
        k = max(0, bisect.bisect_right(starts, lo) - 1)
        while k < len(pieces) and pieces[k][0] < hi:
            a, b, s = pieces[k]
            cover = min(b, hi) - max(a, lo)
            if cover > 0:
                by[s.label] = by.get(s.label, 0.0) + cover
            k += 1
        rest = (hi - lo) - sum(by.values())
        if rest > 1e-9:
            by["(no span)"] = rest
        out.append(by)
    return out
