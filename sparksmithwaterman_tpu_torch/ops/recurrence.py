"""Batched Smith-Waterman DP fill in PyTorch (row form).

Port of :mod:`sparksmithwaterman_tpu.ops.recurrence`.  With the linear gap
penalty the within-row recurrence

    H[i][j] = max(A[j], H[i][j-1] + gap),
    A[j]    = max(0, H[i-1][j-1] + sub(i, j), H[i-1][j] + gap)

unrolls to ``H[i][j] = cummax_k(A[k] - gap*k) + gap*j``: one cumulative
max per DP row, a Python loop over read positions, vector work over the
batch and the reference.

Every function takes tensors and runs on their device.  Scores are
int32 (``torch.cummax`` takes int32 on CPU and CUDA); direction codes are
int8 with the oracle's contract: 0 none, 1 align, 2 insertion,
3 deletion, and 0 for every zero-score cell.  This module is also the
independent check of the scoring kernels on the card.
"""

from __future__ import annotations

import numpy as np
import torch

from sparksmithwaterman_tpu_torch.io.fasta import encode_batch

DIR_NONE = 0
DIR_ALIGN = 1
DIR_INS = 2
DIR_DEL = 3


def _shift_right(x: torch.Tensor) -> torch.Tensor:
    """Shift along the last axis by one, zero-filling the first column."""
    return torch.nn.functional.pad(x[..., :-1], (1, 0))


def _row_update(h_prev, sub, gap: int, ramp):
    """One DP row: from H[i-1] (..., N) and substitution scores to H[i].

    ``ramp`` is ``gap * arange(N)``.  Returns (H_i, a, ins) so callers can
    derive direction codes without recompute.
    """
    a = _shift_right(h_prev) + sub
    ins = h_prev + gap
    cand = torch.clamp_min(torch.maximum(a, ins), 0)
    h = torch.cummax(cand - ramp, dim=-1).values + ramp
    return h, a, ins


def _sub_scores(ref_codes, read_codes, match: int, mismatch: int):
    """Match/mismatch per position; codes are upper-cased at encode time,
    so equality is the reference's case-insensitive compare."""
    return torch.where(ref_codes == read_codes, match, mismatch).to(torch.int32)


def _ramp(n: int, gap: int, device) -> torch.Tensor:
    return gap * torch.arange(n, dtype=torch.int32, device=device)


def score_pairs(reads, refs, match: int, mismatch: int, gap: int):
    """Max local-alignment score for each (read, ref) pair.

    reads: (B, M) uint8 (READ_PAD-padded); refs: (B, N) uint8
    (REF_PAD-padded).  Returns (B,) int32.  Padding needs no mask: pad
    codes match nothing and mismatch/gap < 0, so padded cells decay.
    """
    b, n = refs.shape
    ramp = _ramp(n, gap, refs.device)
    refs_i = refs.to(torch.int32)
    reads_i = reads.to(torch.int32)
    h = torch.zeros((b, n), dtype=torch.int32, device=refs.device)
    best = torch.zeros((b,), dtype=torch.int32, device=refs.device)
    for i in range(reads.shape[1]):
        sub = _sub_scores(refs_i, reads_i[:, i : i + 1], match, mismatch)
        h, _, _ = _row_update(h, sub, gap, ramp)
        best = torch.maximum(best, h.amax(dim=-1))
    return best


def score_grid(reads, refs, match: int, mismatch: int, gap: int):
    """Max score for every (read, ref) combination.

    reads: (R, M) uint8; refs: (C, N) uint8.  Returns (R, C) int32.  The
    (R, C, N) row state lives on the device; callers bound R*C*N.
    """
    r = reads.shape[0]
    c, n = refs.shape
    ramp = _ramp(n, gap, refs.device)
    refs_i = refs.to(torch.int32)[None, :, :]
    reads_i = reads.to(torch.int32)
    h = torch.zeros((r, c, n), dtype=torch.int32, device=refs.device)
    best = torch.zeros((r, c), dtype=torch.int32, device=refs.device)
    for i in range(reads.shape[1]):
        sub = _sub_scores(refs_i, reads_i[:, i, None, None], match, mismatch)
        h, _, _ = _row_update(h, sub, gap, ramp)
        best = torch.maximum(best, h.amax(dim=-1))
    return best


def fill_pairs(
    reads, refs, match: int, mismatch: int, gap: int,
    tie_semantics: str = "serial",
):
    """Full fill for the traceback pass: scores and effective directions.

    reads: (B, M) uint8; refs: (B, N) uint8 (a (1, N) ref broadcasts).
    Returns H (B, M, N) int32 for DP rows 1..M and dirs (B, M, N) int8.

    ``tie_semantics`` mirrors the reference's two engines (scores agree,
    only tied-path codes differ):
      "serial":      '>=' in order d, i, a — ties a > i > d;
      "distributed": strict '>' in the same order — ties d > i > a.
    """
    b = max(reads.shape[0], refs.shape[0])
    n = refs.shape[1]
    m = reads.shape[1]
    device = refs.device
    ramp = _ramp(n, gap, device)
    refs_i = refs.to(torch.int32)
    reads_i = reads.to(torch.int32)
    serial = tie_semantics != "distributed"
    h_all = torch.empty((b, m, n), dtype=torch.int32, device=device)
    dir_all = torch.empty((b, m, n), dtype=torch.int8, device=device)
    h = torch.zeros((b, n), dtype=torch.int32, device=device)
    for i in range(m):
        sub = _sub_scores(refs_i, reads_i[:, i : i + 1], match, mismatch)
        h, a, ins = _row_update(h, sub, gap, ramp)
        d = _shift_right(h) + gap
        if serial:
            first, second, third = (a, DIR_ALIGN), (ins, DIR_INS), (d, DIR_DEL)
        else:
            first, second, third = (d, DIR_DEL), (ins, DIR_INS), (a, DIR_ALIGN)
        code = torch.where(third[0] == h, third[1], DIR_NONE)
        code = torch.where(second[0] == h, second[1], code)
        code = torch.where(first[0] == h, first[1], code)
        h_all[:, i] = h
        dir_all[:, i] = torch.where(h > 0, code, DIR_NONE)
    return h_all, dir_all


def encode_padded(seqs, pad_to: int, pad_value: int) -> np.ndarray:
    """Host-side helper: strings into a (len(seqs), pad_to) uint8 array."""
    return encode_batch(list(seqs), pad_to, pad_value)
