"""Streaming (running) median over an integer stream.

The port's copy of :mod:`sparksmithwaterman_tpu.metrics.running_median`:
the reference's two-heap median (``src/metrics/RunningMedian.java``: a
max-heap below, a min-heap above, sizes kept within one) on
:mod:`heapq`, the low half stored negated.  Optionally journals each
running median to a file, one line per value, as the reference's
file-writer constructor does.
"""

from __future__ import annotations

import heapq
from typing import IO, List, Optional


class RunningMedian:
    def __init__(self, out_path: Optional[str] = None):
        self._low: List[int] = []  # max-heap (negated)
        self._high: List[int] = []  # min-heap
        self._median: float = 0.0
        self._out: Optional[IO[str]] = open(out_path, "w") if out_path else None

    def add(self, value: int) -> float:
        """Insert a value; returns the new running median."""
        if not self._low or value <= -self._low[0]:
            heapq.heappush(self._low, -value)
        else:
            heapq.heappush(self._high, value)
        self._balance()
        self._median = self._calculate()
        if self._out is not None:
            self._out.write(f"{self._median}\n")
        return self._median

    def _balance(self) -> None:
        # Keep |len(low) - len(high)| <= 1.
        if len(self._low) > len(self._high) + 1:
            heapq.heappush(self._high, -heapq.heappop(self._low))
        elif len(self._high) > len(self._low) + 1:
            heapq.heappush(self._low, -heapq.heappop(self._high))

    def _calculate(self) -> float:
        # Odd count: the middle element; even: the mean of the two middles.
        if len(self._low) > len(self._high):
            return float(-self._low[0])
        if len(self._high) > len(self._low):
            return float(self._high[0])
        if not self._low:
            return 0.0
        return (-self._low[0] + self._high[0]) / 2.0

    @property
    def median(self) -> float:
        return self._median

    def close(self) -> None:
        if self._out is not None:
            self._out.close()
            self._out = None
