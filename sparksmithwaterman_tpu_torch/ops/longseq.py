"""Windowed traceback: max cells from one argmax pass, then window fills.

Port of :mod:`sparksmithwaterman_tpu.ops.longseq`, the traceback branch
for long references and large read sets:

1. :func:`find_max_cells_batched` finds every read's max cells with one
   pass of the argmax kernel (K2, ``ops.cuda_score.argmax_lane``); reads
   with a tie inside one DP row are listed by K8
   (``ops.cuda_score.max_cells_row``: the row recurrence of each read,
   every cell equal to its best appended on the device);
2. :func:`sites_for_ref_long_batched` re-fills only a window of reference
   columns ending at each max cell and walks it, one launch per dispatch
   (K9 and K10, ``ops.cuda_score.fill_walk``: each window's codes stay on
   chip, or in a scratch its block walks).

:func:`sites_for_pair_long` is the one-read form: :func:`find_max_cells`
(K5 for the best, K8 for the cells), then step 2 for that read.

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
from sparksmithwaterman_tpu_torch.ops.cuda_score import (
    argmax_lane, fill_walk, max_cells_row, score_grid_row,
)
from sparksmithwaterman_tpu_torch.ops.device_traceback import assemble_site
from sparksmithwaterman_tpu_torch.ops.traceback import degenerate_sites
from sparksmithwaterman_tpu_torch.utils.profiling import span

Cells = Tuple[int, np.ndarray]

# On the CPU, past this many tied cells per read the plain listing stops
# growing and the exact host row scan takes over; a read of best 0 past it
# gets the host scan's answer on any device (as the JAX package's).
_CAPACITY_CAP = 1 << 15
# Slots (reads x capacity) of one K8 listing of the reads past the first
# capacity on the card, each listed at its own count (at least one read).
_SLOT_BUDGET = 1 << 28
# Element budget of the (R, m, n) row stack of one tie group of the plain
# listing (on the CPU; K8 on the card needs no such stack).
_GROUP_BUDGET = 1 << 26
# Window fill jobs per device batch, and (B, M, W) cells of its fill.
_JOB_BLOCK = 512
_FILL_CELLS = 1 << 30


def _to(arr: np.ndarray, device) -> torch.Tensor:
    with span("wait", on="upload"):
        return torch.from_numpy(np.ascontiguousarray(arr)).to(device)


def _host(*tensors: torch.Tensor) -> List[np.ndarray]:
    """The tensors copied to the host, a wait on their device."""
    with span("wait", on="readback"):
        return [t.cpu().numpy() for t in tensors]


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
    reads_enc: np.ndarray, ref_enc: np.ndarray, best: np.ndarray, params, device, capacity: int = 1024
) -> List[Cells]:
    """Exact (best, cells) of each read row against one ref, given each
    read's best: one listing (``max_cells_row``) at ``capacity``, then the
    reads past it once more.  On the card each at the count the first
    listing gave it (K8's memory is its slots, so nothing caps it); on the
    CPU at the next power of two of their largest count, up to
    ``_CAPACITY_CAP``, and the host row scan past that.  A read of best 0
    past ``_CAPACITY_CAP`` gets the host scan's (0, no cells), as JAX's
    ``find_max_cells``."""
    ref_t = _to(ref_enc, device)
    reads_t = _to(reads_enc, device)
    best_t = _to(best.astype(np.int32), device)
    count, cells = _host(*max_cells_row(reads_t, ref_t, best_t, *params, capacity))
    cells = list(cells)
    caps = np.full(len(count), capacity)
    flat = (best <= 0) & (count > _CAPACITY_CAP)
    over = np.flatnonzero((count > capacity) & ~flat)
    for group in _relist_groups(over[np.argsort(count[over], kind="stable")], count, device, capacity):
        cap = int(count[group].max())
        if torch.device(device).type != "cuda":
            cap = min(_CAPACITY_CAP, 1 << (cap - 1).bit_length())
        idx = _to(group, reads_t.device)
        _, more = max_cells_row(reads_t[idx], ref_t, best_t[idx], *params, cap)
        for k, listed in zip(group, _host(more)[0]):
            cells[k], caps[k] = listed, cap
    out: List[Cells] = []
    for k in range(reads_enc.shape[0]):
        b = int(best[k])
        if flat[k]:
            out.append((0, np.empty((0, 2), np.int32)))
        elif count[k] > caps[k]:  # only on the CPU
            out.append(_max_cells_host(reads_enc[k], ref_enc, *params))
        elif b > 0 and count[k] == 0:
            raise RuntimeError(f"read {k} has no cell equal to its best {b}: the best is wrong")
        else:
            out.append((b, cells[k][: int(count[k])]))
    return out


def _relist_groups(over: np.ndarray, count: np.ndarray, device, capacity: int) -> List[np.ndarray]:
    """The reads past the first capacity (``over``, by count ascending) in
    groups of one listing each: on the card groups whose reads x largest
    count stays within _SLOT_BUDGET (at least one read); on the CPU all in
    one, unless the capacity already reached _CAPACITY_CAP."""
    if torch.device(device).type != "cuda":
        return [over] if over.size and capacity < _CAPACITY_CAP else []
    groups: List[np.ndarray] = []
    start = 0
    for end in range(1, over.size + 1):
        if end == over.size or (end + 1 - start) * int(count[over[end]]) > _SLOT_BUDGET:
            groups.append(over[start:end])
            start = end
    return groups


def find_max_cells(read_seq: str, ref_seq: str, params, device="cuda") -> Cells:
    """All (i, j) max cells (0-based, row-major) of one pair; its best from
    K5 (``score_grid_row``, the row-form recurrence on the CPU)."""
    m, n = len(read_seq), len(ref_seq)
    reads_enc = encode_batch([read_seq], m, READ_PAD)
    ref_enc = encode_batch([ref_seq], n, REF_PAD)
    (best,) = _host(score_grid_row(_to(reads_enc, device), _to(ref_enc, device), *params)[:, 0])
    return _exact_max_cells(reads_enc, ref_enc[0], best, params, device)[0]


def find_max_cells_batched(reads: List[str], ref_seq: str, params, device="cuda") -> List[Cells]:
    """Per-read (best, max cells) of a read batch against ONE reference.

    One argmax pass (K2 on a CUDA device, its plain version on the CPU)
    gives each lane's (row best, first diagonal reaching it, tie count).
    A read's max cells are (lane, bestd - lane) over the lanes reaching
    its max when every such lane has count 1; a read with a tie inside
    one DP row is listed by K8 (``max_cells_row``) from that max, keeping
    the all-co-optimal-cells contract (``SmithWaterman.java:176-185``).
    """
    m_pad = max(8, -(-max(len(r) for r in reads) // 8) * 8)
    reads_enc = encode_batch(reads, m_pad, READ_PAD)
    ref_enc = encode_batch([ref_seq], len(ref_seq), REF_PAD)
    best, bestd, count = argmax_lane(_to(reads_enc, device), _to(ref_enc, device), *params)
    best, bestd, count = _host(best[:, 0], bestd[:, 0], count[:, 0])  # (R, M) per lane

    out: List[Optional[Cells]] = []
    ties: List[int] = []
    tie_best = {}
    for ridx in range(len(reads)):
        b = int(best[ridx].max())
        if b == 0:
            out.append((0, np.empty((0, 2), np.int32)))
            continue
        lanes = np.flatnonzero(best[ridx] == b)
        if (count[ridx, lanes] != 1).any():
            out.append(None)
            ties.append(ridx)
            tie_best[ridx] = b
            continue
        out.append((b, np.stack([lanes, bestd[ridx, lanes] - lanes], axis=1).astype(np.int32)))
    # In-lane ties: exact positions, shortest read first, each group's rows
    # as many as its longest read needs.
    ties.sort(key=lambda ridx: len(reads[ridx]))
    for g in _tie_groups(ties, reads, len(ref_seq), device):
        m_g = _tier(len(reads[g[-1]]), 8)
        g_best = np.array([tie_best[ridx] for ridx in g], np.int32)
        for ridx, cells in zip(g, _exact_max_cells(reads_enc[g, :m_g], ref_enc[0], g_best, params, device)):
            out[ridx] = cells
    return out


def _tie_groups(ties: List[int], reads: List[str], n: int, device) -> List[List[int]]:
    """The tied reads (sorted by length) in groups of one listing each: on
    the card one group per width tier (``_tier(len, 8)``), K8's memory
    being O(reads x capacity); on the CPU groups whose (R, m, n) stack of
    the plain listing stays under _GROUP_BUDGET (at least one read)."""
    groups: List[List[int]] = []
    for ridx in ties:
        m = _tier(len(reads[ridx]), 8)
        if groups and (
            _tier(len(reads[groups[-1][0]]), 8) == m
            if torch.device(device).type == "cuda"
            else (len(groups[-1]) + 1) * m * n <= _GROUP_BUDGET
        ):
            groups[-1].append(ridx)
        else:
            groups.append([ridx])
    return groups


def _tier(m: int, step: int) -> int:
    """m rounded up to a multiple of step (at least step)."""
    return max(step, -(-m // step) * step)


def window_width(m: int, n: int, match: int, mismatch: int, gap: int) -> int:
    """Reference columns provably holding any positive path of a length-m
    read (module docstring); 8m/3 + 2 at the default 5/-3/-4."""
    return min(n, m + (match * m) // min(-mismatch, -gap) + 2)


def _fill_walk_known(read_win, windows, cells, match, mismatch, gap, *, cap: int, tie_semantics: str):
    """Window fill + walk of one known max cell per pair (K9 and K10 in
    one launch, ``cuda_score.fill_walk``).

    Returns (begins (B,), codes (B, cap)) in window coordinates."""
    return fill_walk(read_win, windows, cells, match, mismatch, gap, cap=cap, tie_semantics=tie_semantics)


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
        begins, codes = _host(begins, codes)
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


def sites_for_pair_long(
    ref_seq: str,
    read_seq: str,
    params,
    gap_char: str = "_",
    ref_bucket: int = 256,
    max_cells: Optional[Cells] = None,
    tie_semantics: str = "serial",
    device="cuda",
) -> List[Site]:
    """Every optimal site of one (read, long-ref) pair without an O(m*n)
    traceback fill, in the oracle's row-major max-cell order.

    ``max_cells``: a precomputed (best, cells), e.g. one element of
    :func:`find_max_cells_batched`, to skip the search.  A best of 0 gives
    ``degenerate_sites`` (capped, with its truncation note); an empty read
    or reference gives no site.
    """
    if not read_seq or not ref_seq:
        return []
    cells = max_cells if max_cells is not None else find_max_cells(read_seq, ref_seq, params, device)
    return sites_for_ref_long_batched(
        ref_seq, [read_seq], params, gap_char=gap_char, ref_bucket=ref_bucket, cell_lists=[cells],
        tie_semantics=tie_semantics, device=device,
    )[0]
