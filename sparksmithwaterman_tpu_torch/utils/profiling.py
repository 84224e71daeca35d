"""Performance counters and traces: the DP fill rate in GCUPS (giga cell
updates per second, cells = sum |ref| * |read|), and on-demand
``torch.profiler`` chrome traces."""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from typing import Iterator, Optional


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
