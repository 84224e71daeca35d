"""Plain PyTorch Smith-Waterman with a linear gap: the benchmark's reference.

It holds the system under test to the semantics of the upstream serial
engine, worked out again from the generated inputs alone:

- a cell is ``max(0, H[i-1][j-1] + sub, H[i-1][j] + gap, H[i][j-1] + gap)``;
- a read's score against a reference is its best cell; a reference's total
  is the sum of its reads' scores;
- the max cells of a pair are listed in row-major order, and each is walked
  back while the score is positive.  Under ``"serial"`` ties the walk takes
  alignment, then insertion, then deletion (``>=`` against a running best
  that starts at 0); under ``"distributed"`` the strict ``>``;
- a winner's sites are every read's sites in read order, stably sorted by
  their beginning index.

Sequences are arrays of base codes 0-3.  A row of the DP is one step of
a loop: the horizontal term ``H[i][j-1] + gap`` is a prefix max,
``H[i][j] = gap * j + cummax_k<=j(E[k] - gap * k)``, so each step is a
handful of elementwise operations and one ``torch.cummax`` over a batch of
(reads x references x columns).  Integers are int32 throughout; sums are
int64.  Nothing here reads anything that the system under test made.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

# Pad codes of reads and references: each equals no base and not the other.
READ_PAD = 4
REF_PAD = 5
# Elements of one (reads, lanes, columns) operand of a row step.
STEP_ELEMS = 1 << 26
# Columns of a lane of references, at least.
LANE_COLS = 1 << 14
# int32 cells of stored rows (a traceback's H) at once: 8 GB.
STORE_ELEMS = 1 << 31

DIR_NONE, DIR_ALIGN, DIR_INS, DIR_DEL = 0, 1, 2, 3

Site = Tuple[int, Tuple[str, str]]


def pad_rows(seqs: Sequence[np.ndarray], pad: int) -> np.ndarray:
    """(len(seqs), longest) uint8 codes, ``pad`` past each end."""
    out = np.full((len(seqs), max(len(s) for s in seqs)), pad, np.uint8)
    for k, s in enumerate(seqs):
        out[k, : len(s)] = s
    return out


def _row_step(h, read_col, refs, ramp, scheme):
    """The next row of H (without its column 0) from the previous ``h``
    (with it): (B, C, N) int32."""
    match, mismatch, gap = scheme
    sub = torch.where(read_col[:, None, None] == refs[None], match, mismatch).to(torch.int32)
    e = torch.maximum(h[..., :-1] + sub, h[..., 1:] + gap).clamp_min_(0)
    return torch.cummax(e + ramp, dim=-1).values - ramp


def _lanes(lens: Sequence[int], width: int) -> List[List[int]]:
    """References (by index, in order) laid into lanes of ``width``
    columns, each reference after a column of its own (its column 0)."""
    lanes: List[List[int]] = [[]]
    used = 0
    for k, n in enumerate(lens):
        if lanes[-1] and used + n + 1 > width:
            lanes.append([])
            used = 0
        lanes[-1].append(k)
        used += n + 1
    return lanes


def best_scores(reads: Sequence[np.ndarray], refs: Sequence[np.ndarray], scheme, device) -> np.ndarray:
    """(len(reads), len(refs)) int64: each read's best cell against each
    reference.

    The references of a chunk lie side by side in lanes of columns (rows
    of at least LANE_COLS columns, scanned in parallel), each after a
    column held at 0 (its column 0); the columns past a lane's last
    reference form one more segment that is read by nothing.  The prefix
    max of the horizontal term runs along a lane with each reference's keys
    raised above every key before it (an offset per reference larger than
    any key's range), so it never reaches across a reference's start.
    Reads go in blocks of similar length; rows past a read's end hold a pad
    code, which matches nothing, so every cell there is below the best real
    cell above it and the best over the block is the best over the pair.
    """
    out = np.zeros((len(reads), len(refs)), np.int64)
    if not len(reads) or not len(refs):
        return out
    match, mismatch, gap = scheme
    longest_read = max(len(r) for r in reads)
    read_order = np.argsort([len(r) for r in reads], kind="stable")
    width = max(LANE_COLS, max(len(r) for r in refs) + 1)
    read_block = max(1, min(len(reads), STEP_ELEMS // width))
    lanes = _lanes([len(r) for r in refs], width)
    per_chunk = max(1, STEP_ELEMS // (read_block * width))
    for first in range(0, len(lanes), per_chunk):
        chunk_lanes = lanes[first : first + per_chunk]
        chunk = [k for lane in chunk_lanes for k in lane]
        where = {k: j for j, k in enumerate(chunk)}
        cols = np.full((len(chunk_lanes), width), REF_PAD, np.uint8)
        seg = np.full((len(chunk_lanes), width), len(chunk), np.int64)  # past the last reference: read by nothing
        rank = np.zeros((len(chunk_lanes), width), np.int64)
        local = np.zeros((len(chunk_lanes), width), np.int64)
        starts = np.zeros((len(chunk_lanes), width), bool)
        for lane_no, lane in enumerate(chunk_lanes):
            at = 0
            for r, k in enumerate(lane):
                n = len(refs[k])
                cols[lane_no, at + 1 : at + 1 + n] = refs[k]
                seg[lane_no, at : at + 1 + n] = where[k]
                rank[lane_no, at : at + 1 + n] = r
                local[lane_no, at : at + 1 + n] = np.arange(n + 1)
                starts[lane_no, at] = True
                at += n + 1
            rank[lane_no, at:] = len(lane)
            local[lane_no, at:] = np.arange(width - at)
            starts[lane_no, at:at + 1] = True
        # Keys of one reference span [0, match x longest read + (-gap) x the lane's width]:
        # an offset per reference past that keeps the prefix max inside it.
        big = match * longest_read + (-gap) * width + 1
        dtype = torch.int32 if big * (int(rank.max()) + 1) < (1 << 31) - big else torch.int64
        key_base = torch.from_numpy((-gap) * local + big * rank).to(device=device, dtype=dtype)
        starts_t = torch.from_numpy(starts).to(device)
        # Substitution lanes by read code: a read base's lanes are one gather.
        cols_t = torch.from_numpy(cols).to(device)
        codes = torch.arange(max(READ_PAD, 3) + 1, device=device, dtype=torch.uint8)
        sub_rows = torch.where(codes[:, None, None] == cols_t[None], match, mismatch).to(dtype)
        seg_t = torch.from_numpy(seg.reshape(-1)).to(device)
        for lo in range(0, len(reads), read_block):
            rows = read_order[lo : lo + read_block]
            reads_t = torch.from_numpy(pad_rows([reads[k] for k in rows], READ_PAD)).to(device).long()
            h = torch.zeros((len(rows), len(chunk_lanes), width), dtype=dtype, device=device)
            best = torch.zeros_like(h)
            e = torch.zeros_like(h)
            for i in range(reads_t.shape[1]):
                torch.maximum(h[..., :-1] + sub_rows[reads_t[:, i]][..., 1:], h[..., 1:] + gap, out=e[..., 1:])
                e.clamp_min_(0).masked_fill_(starts_t, 0)
                h = torch.cummax(e + key_base, dim=-1).values - key_base
                torch.maximum(best, h, out=best)
            per_ref = torch.zeros((len(rows), len(chunk) + 1), dtype=dtype, device=device)
            per_ref.scatter_reduce_(1, seg_t.expand(len(rows), -1), best.reshape(len(rows), -1), "amax")
            out[np.ix_(rows, chunk)] = per_ref[:, :-1].cpu().numpy()
    return out


def totals(reads: Sequence[np.ndarray], refs: Sequence[np.ndarray], scheme, device) -> np.ndarray:
    """(len(refs),) int64: each reference's total over every read."""
    return best_scores(reads, refs, scheme, device).sum(axis=0)


_BASES = np.frombuffer(b"ACGT", np.uint8)


def _walk(w: np.ndarray, r: int, c: int, lo: int, read: np.ndarray, ref: np.ndarray, scheme, strict: bool,
          gap_char: str):
    """The site walked back from cell (r, lo + c) over ``w``, the rows 0..r
    and columns lo..lo + c of one read's H; None where the walk reaches
    the window's left edge with a positive score (the window was too
    narrow)."""
    match, mismatch, gap = scheme
    begin = 0
    ref_parts: List[str] = []
    read_parts: List[str] = []
    while w[r, c] > 0:
        if c == 0:
            return None
        begin = lo + c
        left = int(w[r, c - 1]) + gap
        up = int(w[r - 1, c]) + gap
        diag = int(w[r - 1, c - 1]) + (match if read[r - 1] == ref[lo + c - 1] else mismatch)
        best = max(0, left)
        if (up > best) if strict else (up >= best):
            step = DIR_INS
        elif (left > 0) if strict else (left >= 0):
            step = DIR_DEL
        else:
            step = DIR_NONE
        if (diag > max(best, up)) if strict else (diag >= max(best, up)):
            step = DIR_ALIGN
        if step == DIR_ALIGN:
            ref_parts.append(chr(_BASES[ref[lo + c - 1]]))
            read_parts.append(chr(_BASES[read[r - 1]]))
            r, c = r - 1, c - 1
        elif step == DIR_INS:
            ref_parts.append(gap_char)
            read_parts.append(chr(_BASES[read[r - 1]]))
            r -= 1
        else:
            ref_parts.append(chr(_BASES[ref[lo + c - 1]]))
            read_parts.append(gap_char)
            c -= 1
    return begin, ("".join(reversed(ref_parts)), "".join(reversed(read_parts)))


def _site(h, b: int, i: int, j: int, read, ref, scheme, strict: bool, gap_char: str) -> Site:
    """Walk cell (i, j) of read b back on the host, over a window of H
    copied from the device: first i + 64 columns wide, else as wide as a
    path of positive score can reach (match x i / -gap deletions)."""
    match, _, gap = scheme
    for span in (i + 64, i + match * i // (-gap) + 2):
        lo = max(0, j - span)
        site = _walk(h[b, : i + 1, lo : j + 1].cpu().numpy(), i, j - lo, lo, read, ref, scheme, strict, gap_char)
        if site is not None:
            return site
    raise AssertionError("a walk reached past its widest window")


def read_sites(reads: Sequence[np.ndarray], ref: np.ndarray, scheme, device, gap_char: str = "_",
               tie_semantics: str = "serial", first_only: bool = False) -> Tuple[np.ndarray, List[List[Site]]]:
    """(best (len(reads),) int64, [each read's sites]) of every read against
    one reference: one site per max cell, in row-major order.

    ``first_only`` keeps each read's first max cell alone; that breaks the
    guarantee of every co-optimal site, and serves as the benchmark's
    control.  A read whose best is 0 (every cell a max cell) raises: the
    benchmark's traffic has none.
    """
    strict = tie_semantics == "distributed"
    n = len(ref)
    ref_t = torch.from_numpy(np.asarray(ref, np.uint8)).to(device)
    ramp = torch.arange(1, n + 1, device=device, dtype=torch.int32) * (-scheme[2])
    best_all = np.zeros(len(reads), np.int64)
    sites: List[List[Site]] = [[] for _ in reads]
    order = np.argsort([len(r) for r in reads], kind="stable")
    start = 0
    while start < len(reads):
        stop = start + 1
        # Reads ascend in length: a block's H holds (B, longest + 1, n + 1) cells.
        while stop < len(reads) and (stop + 1 - start) * (len(reads[order[stop]]) + 1) * (n + 1) <= STORE_ELEMS:
            stop += 1
        rows = order[start:stop]
        reads_np = pad_rows([reads[k] for k in rows], READ_PAD)
        reads_t = torch.from_numpy(reads_np).to(device)
        bsz, m = reads_np.shape
        h = torch.zeros((bsz, m + 1, n + 1), dtype=torch.int32, device=device)
        for i in range(m):
            h[:, i + 1, 1:] = _row_step(h[:, i, None], reads_t[:, i], ref_t[None], ramp, scheme)[:, 0]
        # Rows past a read's end are each below the best real cell (they
        # match nothing), so they hold no max cell while the best is positive.
        best = h.amax(dim=(1, 2))
        if bool((best == 0).any()):
            raise ValueError("a read scores 0 against the reference: every cell would be a max cell")
        b, i, j = (h == best[:, None, None]).nonzero(as_tuple=True)  # row-major within each read
        if first_only:
            first = torch.ones_like(b, dtype=torch.bool)
            first[1:] = b[1:] != b[:-1]
            b, i, j = b[first], i[first], j[first]
        best_np = best.cpu().numpy()
        for k, row in enumerate(rows):
            best_all[row] = best_np[k]
        for bk, ik, jk in zip(b.tolist(), i.tolist(), j.tolist()):
            row = rows[bk]
            sites[row].append(_site(h, bk, ik, jk, reads[row], ref, scheme, strict, gap_char))
        del h
        start = stop
    return best_all, sites


def winner_sites(per_read: List[List[Site]]) -> List[Site]:
    """A winner's sites: read order, then a stable sort by beginning index."""
    merged = [site for sites in per_read for site in sites]
    merged.sort(key=lambda s: s[0])
    return merged
