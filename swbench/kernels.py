"""The yardstick of the kernels: the card's peaks, the least time a kernel's
work can take on it, and K1's work counted from what the host knows.

The bound is the larger of two times:

- the real DP cells (no padding) x INSTR_PER_CELL instructions over the
  SMs' instruction rate, SMs x 4 schedulers x 32 threads x the card's
  maximum SM clock: the fewest instructions of the recurrence, two 16-bit
  cells a register and three DPX instructions a register;
- the bytes (each input read once, each output written once) over the
  H100 SXM data sheet's 3.35 TB/s.

On an H100 SXM (132 SMs, 1,980 MHz) the first is 22,302 GCUPS.
"""

from __future__ import annotations

import subprocess
from typing import List, Optional, Tuple

HBM_BYTES_PER_S = 3.35e12
INSTR_PER_SM_CLOCK = 4 * 32
INSTR_PER_CELL = 1.5

# K1, the packed scoring kernel, in both forms; arguments (packed, rows, m,
# refs, offsets, lens, c, ...): row lanes m <= ONE_PASS_LANES run the
# one-pass kernels, wider rows the striped ones.
K1_ENTRIES = ("swt_lane_best_varlen", "swt_lane_best_varlen_s16x2")
ONE_PASS_LANES = 1024


def bound_ms(cells: int, nbytes: int, sms: int, clock_mhz: float) -> Tuple[float, str]:
    """(least ms, "operations" or "bytes") of this work on the card."""
    ops_ms = cells * INSTR_PER_CELL / (sms * INSTR_PER_SM_CLOCK * clock_mhz * 1e6) * 1e3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def card_peaks(device: int) -> Tuple[int, float]:
    """(SMs, maximum SM clock in MHz) of a card, as read in this run."""
    import torch

    sms = torch.cuda.get_device_properties(device).multi_processor_count
    out = subprocess.run(["nvidia-smi", "-i", str(device), "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"], capture_output=True, text=True, timeout=60, check=True)
    return sms, float(out.stdout.strip().splitlines()[0])


def card_power_limit(device: int) -> Optional[str]:
    out = subprocess.run(["nvidia-smi", "-i", str(device), "--query-gpu=power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    return out.stdout.strip() or None


def k1_bytes(args: tuple, ref_bytes: float) -> float:
    """A K1 launch's bytes: its packed rows (int32) and its (c, rows, m)
    int32 output, and its references at ``ref_bytes`` each."""
    rows, m, c = int(args[1]), int(args[2]), int(args[6])
    return 4.0 * rows * m * (1 + c) + c * ref_bytes


def flush_value(args, kwargs, result) -> dict:
    """What a traced scoring flush (``TorchBatchBackend._dispatch_cols``)
    keeps: its real cells, the bases and the number of its references."""
    ref_seqs = args[2]
    return {"cells": int(result[1]), "ref_bp": sum(len(s) for s in ref_seqs), "refs": len(ref_seqs)}


def k1_roofline(trace, wide: bool) -> Optional[float]:
    """K1's share of its bound, in %, over the scoring flushes whose K1
    launches are all of one form: one-pass (``wide=False``) or striped.
    The real cells of those flushes over the event-timed ms of their K1
    launches, summed over the cards; flushes that mix the forms count in
    neither, and the run's notes say how many there were."""
    cells = nbytes = ms = 0.0
    mixed = 0
    launches = trace.launches_of(K1_ENTRIES)
    for t0, t1, flush in trace.spans_named("flush"):
        mine: List = [x for x in launches if t0 <= x.host_t <= t1]
        if not mine or flush is None:
            continue
        kinds = {int(x.args[2]) > ONE_PASS_LANES for x in mine}
        if len(kinds) > 1:
            mixed += 1
            continue
        if kinds != {wide}:
            continue
        ref_bytes = flush["ref_bp"] / max(1, flush["refs"])
        cells += flush["cells"]
        nbytes += sum(k1_bytes(x.args, ref_bytes) for x in mine)
        ms += sum(x.ms for x in mine)
    if mixed:
        trace.notes.append(f"{'k1_wide' if wide else 'k1'}_roofline: {mixed} flushes mixed K1's forms, skipped")
    if ms <= 0 or cells <= 0:
        return None
    return 100.0 * bound_ms(int(cells), int(nbytes), trace.sms, trace.clock_mhz)[0] / ms
