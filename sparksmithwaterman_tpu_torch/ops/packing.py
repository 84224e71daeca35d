"""Lane packing: several reads per kernel row.

Port of :mod:`sparksmithwaterman_tpu.ops.packing`.  The wavefront kernel
puts read positions in lanes; packing bins reads back-to-back into
``m_pack``-lane rows and marks each read's first lane with
``START_BIT``.  The kernel restarts the DP boundary at marked lanes and
finishes with a segmented suffix max, so each read's best score sits at
its start lane.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from sparksmithwaterman_tpu_torch.io.fasta import READ_PAD, encode_seq

# Segment-start marker OR-ed into a packed lane's read code (codes < 256).
START_BIT = 256


def pack_reads(
    reads: Sequence[str],
    m_pack: int,
    row_multiple: int = 8,
) -> Tuple[np.ndarray, np.ndarray]:
    """Bin-pack reads into ``m_pack``-lane rows (best-fit decreasing).

    Returns:
      packed: (ROWS, m_pack) int32 — ASCII codes with ``START_BIT`` on
        each read's first lane (and on the first trailing-pad lane, so
        trailing lanes form their own all-pad segment scoring exactly 0).
      start_idx: (len(reads),) int32 — flat lane index (row * m_pack +
        lane) of each read's first lane.

    ROWS is padded to a multiple of ``row_multiple`` with all-pad rows.
    Empty reads get one pad lane (their segment scores 0, the oracle's
    score for an empty read).
    """
    n_reads = len(reads)
    lens = [max(1, len(s)) for s in reads]  # empty read -> 1 pad lane
    if any(l > m_pack for l in lens):
        raise ValueError(f"read longer than m_pack={m_pack}")
    order = sorted(range(n_reads), key=lambda i: -lens[i])
    # Best-fit decreasing over residual-capacity buckets: the tightest
    # adequate row, FIFO within a bucket; O(n * m_pack) worst case.
    rows: List[List[int]] = []
    space: List[int] = []
    by_residual: List[List[int]] = [[] for _ in range(m_pack + 1)]
    for i in order:
        li = lens[i]
        for res in range(li, m_pack + 1):
            if by_residual[res]:
                r = by_residual[res].pop()
                rows[r].append(i)
                space[r] = res - li
                by_residual[res - li].append(r)
                break
        else:
            rows.append([i])
            space.append(m_pack - lens[i])
            by_residual[m_pack - lens[i]].append(len(rows) - 1)
    n_rows = -(-max(1, len(rows)) // row_multiple) * row_multiple
    packed = np.full((n_rows, m_pack), READ_PAD, np.int32)
    start_idx = np.zeros(n_reads, np.int32)
    packed[:, 0] |= START_BIT  # all-pad rows: one harmless segment
    for r, members in enumerate(rows):
        o = 0
        for i in members:
            enc = encode_seq(reads[i])
            packed[r, o : o + max(1, enc.size)] = (
                enc if enc.size else READ_PAD
            )
            packed[r, o] |= START_BIT
            start_idx[i] = r * m_pack + o
            o += lens[i]
        if o < m_pack:
            packed[r, o] |= START_BIT  # isolate trailing pad lanes
    return packed, start_idx


def _start_lanes(lane_best: torch.Tensor, start_idx) -> torch.Tensor:
    flat = lane_best.reshape(lane_best.shape[0], -1)
    idx = torch.as_tensor(start_idx, dtype=torch.int64, device=flat.device)
    return flat.index_select(1, idx)  # (C, R)


def read_best(lane_best: torch.Tensor, start_idx) -> torch.Tensor:
    """(C, ROWS, M) kernel output -> (num_reads, C) per-read best (int32)."""
    return _start_lanes(lane_best, start_idx).T


def packed_col_sums(lane_best: torch.Tensor, start_idx) -> torch.Tensor:
    """(C, ROWS, M) kernel output -> (C,) per-ref column sums (int64)."""
    return _start_lanes(lane_best, start_idx).sum(dim=1, dtype=torch.int64)
