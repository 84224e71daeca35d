"""Performance counters: the DP fill rate in GCUPS (giga cell updates per
second, cells = sum |ref| * |read|)."""

from __future__ import annotations

import contextlib
import dataclasses
import time


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
