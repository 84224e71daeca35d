"""Windowed traceback: max cells from one argmax pass, then window fills.

Port of :mod:`sparksmithwaterman_tpu.ops.longseq`, the traceback branch
for long references and large read sets:

1. :func:`find_max_cells_batched` finds every read's max cells with one
   pass of the argmax kernel (K2, ``ops.cuda_score.argmax_lane``); reads
   with a tie inside one DP row fall back to an exact row scan;
2. :func:`sites_for_ref_long_batched` re-fills only a window of reference
   columns ending at each max cell and walks it on the device.

Window soundness, for any scoring scheme: a path with score >= 1 has
(mismatches + deletions) * min(|mismatch|, |gap|) < match * m, so its
reference span is below m + match*m / min(|mismatch|, |gap|).  A window
that wide (plus 2) holds the whole path, and its left edge behaves like
a matrix edge because H has decayed to 0 there.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from sparksmithwaterman_tpu_torch.io.fasta import READ_PAD, REF_PAD, encode_batch, encode_seq
from sparksmithwaterman_tpu_torch.io.report import Site
from sparksmithwaterman_tpu_torch.ops.cuda_score import argmax_lane
from sparksmithwaterman_tpu_torch.ops.device_traceback import (
    argwhere_rows,
    assemble_site,
    trace_cells,
)
from sparksmithwaterman_tpu_torch.ops.recurrence import _ramp, _row_update, _sub_scores, fill_pairs
from sparksmithwaterman_tpu_torch.ops.traceback import degenerate_sites

Cells = Tuple[int, np.ndarray]

# Past this many tied cells per read the device argwhere stops doubling
# and the exact host row scan takes over.
_CAPACITY_CAP = 1 << 15
# Element budget of the (m, R, n) row stack of one fallback group.
_GROUP_BUDGET = 1 << 26
# Window fill jobs per device batch, and (B, M, W) cells of its fill.
_JOB_BLOCK = 512
_FILL_CELLS = 1 << 30


def _to(arr: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(arr)).to(device)


def _max_cells_device_batch(reads_enc, ref_enc, match, mismatch, gap, capacity: int):
    """(R, m) reads vs ONE ref (n,), on the tensors' device.

    Returns (best (R,), count (R,), cells (R, capacity, 2)) with cells
    row-major and -1-filled.  Pad rows (READ_PAD matches nothing) decay,
    so they never add max cells when best > 0.
    """
    r, m = reads_enc.shape
    n = ref_enc.shape[-1]
    device = ref_enc.device
    ramp = _ramp(n, gap, device)
    ref_i = ref_enc.to(torch.int32)[None, :]
    reads_i = reads_enc.to(torch.int32)
    h = torch.zeros((r, n), dtype=torch.int32, device=device)
    stack = torch.empty((r, m, n), dtype=torch.int32, device=device)
    for i in range(m):
        sub = _sub_scores(ref_i, reads_i[:, i : i + 1], match, mismatch)
        h, _, _ = _row_update(h, sub, gap, ramp)
        stack[:, i] = h
    best = stack.amax(dim=(1, 2))
    eq = stack == best[:, None, None]
    count = eq.sum(dim=(1, 2), dtype=torch.int64)
    return best, count, argwhere_rows(eq, capacity)


def _max_cells_host(read_enc: np.ndarray, ref_enc: np.ndarray, match, mismatch, gap) -> Cells:
    """Exact host row scan: (best, cells) with unbounded tie capacity and
    O(n) memory (two passes: find best, then collect row-major cells)."""
    match, mismatch, gap = int(match), int(mismatch), int(gap)
    ref_i = ref_enc.astype(np.int64)
    n = ref_i.shape[-1]
    ramp = gap * np.arange(n, dtype=np.int64)

    def rows():
        h = np.zeros(n, np.int64)
        for i in range(read_enc.shape[-1]):
            sub = np.where(ref_i == int(read_enc[i]), match, mismatch)
            nw = np.concatenate(([0], h[:-1])) + sub
            cand = np.maximum(np.maximum(nw, h + gap), 0)
            h = np.maximum.accumulate(cand - ramp) + ramp
            yield i, h

    best = 0
    for _, h in rows():
        best = max(best, int(h.max()))
    if best <= 0:
        return 0, np.empty((0, 2), np.int32)
    parts = []
    for i, h in rows():
        js = np.flatnonzero(h == best)
        if js.size:
            parts.append(np.stack([np.full(js.size, i, np.int32), js], axis=1))
    if not parts:
        return best, np.empty((0, 2), np.int32)
    return best, np.concatenate(parts, axis=0).astype(np.int32)


def _exact_max_cells(
    reads_enc: np.ndarray, ref_enc: np.ndarray, params, device, capacity: int = 1024
) -> List[Cells]:
    """Exact (best, cells) of each read row against one ref: device
    argwhere with doubling capacity, host row scan past _CAPACITY_CAP."""
    ref_t = _to(ref_enc, device)
    reads_t = _to(reads_enc, device)
    while True:
        best, count, cells = _max_cells_device_batch(reads_t, ref_t, *params, capacity=capacity)
        count = count.cpu().numpy()
        if (count <= capacity).all() or capacity >= _CAPACITY_CAP:
            break
        capacity *= 2
    best, cells = best.cpu().numpy(), cells.cpu().numpy()
    out: List[Cells] = []
    for k in range(reads_enc.shape[0]):
        if count[k] > capacity:
            out.append(_max_cells_host(reads_enc[k], ref_enc, *params))
        else:
            out.append((int(best[k]), cells[k][: int(count[k])]))
    return out


def find_max_cells(read_seq: str, ref_seq: str, params, device="cuda") -> Cells:
    """All (i, j) max cells (0-based, row-major) of one pair."""
    m, n = len(read_seq), len(ref_seq)
    return _exact_max_cells(
        encode_batch([read_seq], m, READ_PAD), encode_batch([ref_seq], n, REF_PAD)[0], params, device
    )[0]


def find_max_cells_batched(reads: List[str], ref_seq: str, params, device="cuda") -> List[Cells]:
    """Per-read (best, max cells) of a read batch against ONE reference.

    One argmax pass (K2 on a CUDA device, its plain version on the CPU)
    gives each lane's (row best, first diagonal reaching it, tie count).
    A read's max cells are (lane, bestd - lane) over the lanes reaching
    its max when every such lane has count 1; a read with a tie inside
    one DP row falls back to the exact scan, keeping the all-co-optimal-
    cells contract (``SmithWaterman.java:176-185``).
    """
    m_pad = max(8, -(-max(len(r) for r in reads) // 8) * 8)
    reads_enc = encode_batch(reads, m_pad, READ_PAD)
    ref_enc = encode_batch([ref_seq], len(ref_seq), REF_PAD)
    best, bestd, count = argmax_lane(_to(reads_enc, device), _to(ref_enc, device), *params)
    best = best[:, 0].cpu().numpy()  # (R, M) per-lane best
    bestd = bestd[:, 0].cpu().numpy()
    count = count[:, 0].cpu().numpy()

    out: List[Optional[Cells]] = []
    ties: List[int] = []
    for ridx in range(len(reads)):
        b = int(best[ridx].max())
        if b == 0:
            out.append((0, np.empty((0, 2), np.int32)))
            continue
        lanes = np.flatnonzero(best[ridx] == b)
        if (count[ridx, lanes] != 1).any():
            out.append(None)
            ties.append(ridx)
            continue
        out.append((b, np.stack([lanes, bestd[ridx, lanes] - lanes], axis=1).astype(np.int32)))
    # In-lane ties: exact positions, a group of reads per row scan, shortest
    # first, each group's rows as many as its longest read needs.
    ties.sort(key=lambda ridx: len(reads[ridx]))
    start = 0
    while start < len(ties):
        stop = start + 1
        while stop < len(ties) and (stop + 1 - start) * _tier(len(reads[ties[stop]]), 8) * len(ref_seq) <= _GROUP_BUDGET:
            stop += 1
        g = ties[start:stop]
        m_g = _tier(len(reads[g[-1]]), 8)
        for ridx, cells in zip(g, _exact_max_cells(reads_enc[g, :m_g], ref_enc[0], params, device)):
            out[ridx] = cells
        start = stop
    return out


def _tier(m: int, step: int) -> int:
    """m rounded up to a multiple of step (at least step)."""
    return max(step, -(-m // step) * step)


def window_width(m: int, n: int, match: int, mismatch: int, gap: int) -> int:
    """Reference columns provably holding any positive path of a length-m
    read (module docstring); 8m/3 + 2 at the default 5/-3/-4."""
    return min(n, m + (match * m) // min(-mismatch, -gap) + 2)


def _fill_walk_known(read_win, windows, cells, match, mismatch, gap, *, cap: int, tie_semantics: str):
    """Window fill + device walk of one known max cell per pair.

    Returns (begins (B,), codes (B, cap)) in window coordinates."""
    _h, dirs = fill_pairs(read_win, windows, match, mismatch, gap, tie_semantics=tie_semantics)
    begins, codes = trace_cells(dirs, cells[:, None, :], cap)
    return begins[:, 0], codes[:, 0]


def sites_for_ref_long_batched(
    ref_seq: str,
    reads: Sequence[str],
    params,
    *,
    gap_char: str = "_",
    ref_bucket: int = 256,
    cell_lists: List[Cells],
    tie_semantics: str = "serial",
    device="cuda",
) -> List[List[Site]]:
    """Per-read site lists against ONE reference: every max cell's window
    filled and walked in batched device dispatches, only (begin, codes)
    fetched.  Site order per read = row-major max-cell order.

    Jobs go longest read first, each dispatch sized by its first (longest)
    read's window to at most ``_JOB_BLOCK`` jobs and ``_FILL_CELLS``
    cells: a window holding a read's every positive path gives the same
    walk whatever its width, so a long read in the set widens only the
    fills it shares."""
    n = len(ref_seq)
    out: List[List[Site]] = [[] for _ in reads]
    if n == 0 or not any(reads):
        return out
    ref_codes = encode_seq(ref_seq)

    jobs: List[Tuple[int, int, int]] = []  # (read idx, 1-based row, 1-based end col)
    for ridx, read in enumerate(reads):
        best, cells = cell_lists[ridx]
        if best == 0:
            out[ridx] = degenerate_sites(len(read), n)
            continue
        for ci, cj in cells:
            jobs.append((ridx, int(ci) + 1, int(cj) + 1))
    jobs.sort(key=lambda job: -len(reads[job[0]]))  # stable: each read's jobs keep their order

    dispatched = []
    start = 0
    while start < len(jobs):
        m_max = len(reads[jobs[start][0]])
        w = window_width(m_max, n, *(int(p) for p in params))
        w_pad = max(ref_bucket, -(-w // ref_bucket) * ref_bucket)
        chunk = jobs[start : start + max(1, min(_JOB_BLOCK, _FILL_CELLS // (m_max * w_pad)))]
        start += len(chunk)
        windows = np.full((len(chunk), w_pad), REF_PAD, np.uint8)
        cells = np.zeros((len(chunk), 2), np.int32)
        for t, (ridx, i, j) in enumerate(chunk):
            j0 = max(0, j - w)
            windows[t, w_pad - (j - j0) :] = ref_codes[j0:j]
            cells[t] = (i - 1, w_pad - 1)  # 0-based max cell in the window
        read_win = encode_batch([reads[ridx] for ridx, _, _ in chunk], m_max, READ_PAD)
        outs = _fill_walk_known(
            _to(read_win, device), _to(windows, device), _to(cells, device),
            *params, cap=m_max + w_pad, tie_semantics=tie_semantics,  # a walk step takes a row or a column
        )
        dispatched.append((chunk, w_pad, outs))
    for chunk, w_pad, (begins, codes) in dispatched:
        begins, codes = begins.cpu().numpy(), codes.cpu().numpy()
        for t, (ridx, i, j) in enumerate(chunk):
            off = j - w_pad  # window col c <-> ref col c + off
            beg_w = int(begins[t])
            out[ridx].append(
                assemble_site(
                    codes[t], beg_w + off if beg_w > 0 else 0, (i - 1, j - 1),
                    ref_seq, reads[ridx], gap_char,
                )
            )
    return out
