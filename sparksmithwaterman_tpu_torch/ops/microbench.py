"""The step-chain ceiling of the recurrence on the card.

Counterpart of ``sparksmithwaterman_tpu.ops.microbench.vpu_step_roofline``:
the wavefront step of the scoring kernels run ``steps`` times on a state
held in registers, with a constant substitution row and no memory
traffic, through K6 (:func:`..ops.cuda_score.step_chain_best`).  Its cell
rate is the fastest this step form runs on the card; the bench reads it
as ``roofline_gcups``.  The card has no VPU, hence the name.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from sparksmithwaterman_tpu_torch.ops import cuda_score
from sparksmithwaterman_tpu_torch.ops.packing import START_BIT


def seconds_per_call(fn, iters: int, device) -> float:
    """Mean seconds of ``fn()`` over ``iters`` calls after one warm call:
    CUDA events on the card (no host fetch), the host clock on the CPU."""
    fn()
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3 / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) / iters


def roofline_reads(rb: int, m: int, lane0_starts: bool = False) -> np.ndarray:
    """(rb, m) int32 rows of the step chain: the JAX microbench's codes 2-5
    from ``numpy.random.default_rng(0)``, with START_BIT on lane 0 of every
    row when ``lane0_starts``."""
    reads = np.random.default_rng(0).integers(2, 6, size=(rb, m)).astype(np.int32)
    if lane0_starts:
        reads[:, 0] |= START_BIT
    return reads


def step_roofline(
    rb: int = 248,
    m: int = 256,
    steps: int = 131_072,
    iters: int = 20,
    unroll: int = 64,
    params=(5, -3, -4),
    masked: bool = False,
    device="cuda",
    lane0_starts: bool = False,
) -> float:
    """Measured step-chain ceiling in padded GCUPS (rb * m * steps cells
    per call) of K6 at kernel shapes; the defaults are the JAX function's
    (the packed path's rows), and so are the inputs: codes 2-5 drawn by
    ``numpy.random.default_rng(0)`` (:func:`roofline_reads`).
    ``masked=True`` adds the time-packing probe's moving boundary;
    ``lane0_starts=True`` restarts every row at lane 0, as each read of
    the scoring kernels restarts (K6 then takes the 16-bit form where
    ``match * m`` fits int16, ``cuda_score.step_form``).  Timed by
    :func:`seconds_per_call` (on the CPU: the plain version); the rows'
    lane-0 starts are read once before the timed calls, so that no call
    waits on a sync."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not available")
    reads = torch.from_numpy(roofline_reads(rb, m, lane0_starts)).to(device)
    starts = cuda_score.lane0_starts(reads)
    match, mismatch, gap = (int(p) for p in params)
    seconds = seconds_per_call(
        lambda: cuda_score._step_chain_best(
            reads, steps=steps, unroll=unroll, match=match, mismatch=mismatch, gap=gap, masked=masked, starts=starts
        ),
        iters, device,
    )
    return rb * m * steps / seconds / 1e9
