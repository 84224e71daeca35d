"""Serial Smith-Waterman oracle in NumPy, the same contract as
:mod:`sparksmithwaterman_tpu.core.oracle` (the reference's serial engine).

- Candidates go deletion (W + gap), insertion (N + gap), alignment
  (NW + match/mismatch), each compared with ``>=`` (``"serial"``) or
  ``>`` (``"distributed"``) against a running max that starts at
  ``(0, none)``.
- Max cells are found in row-major order; if the max stays 0 every cell
  is a max cell, each with an empty traceback.
- The traceback walks while the score is > 0, recording ``beginning = j``
  before each move; the gap character is ``scoring.gap_char``.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from sparksmithwaterman_tpu_torch.config import ScoringScheme

Site = Tuple[int, Tuple[str, str]]

DIR_NONE = 0
DIR_ALIGN = 1
DIR_INS = 2
DIR_DEL = 3


def fill_matrices(
    ref_seq: str,
    read_seq: str,
    scoring: ScoringScheme = ScoringScheme(),
    tie_semantics: str = "serial",
) -> Tuple[np.ndarray, np.ndarray, int, List[Tuple[int, int]]]:
    """(scores, dirs, max_score, max_cells) of the (m+1, n+1) fill."""
    ref = ref_seq.upper()
    read = read_seq.upper()
    m, n = len(read), len(ref)
    scores = np.zeros((m + 1, n + 1), dtype=np.int64)
    dirs = np.zeros((m + 1, n + 1), dtype=np.int8)
    match, mismatch, gap = scoring.match, scoring.mismatch, scoring.gap
    if tie_semantics not in ("serial", "distributed"):
        raise ValueError(f"unknown tie_semantics: {tie_semantics!r}")
    strict = tie_semantics == "distributed"

    max_score = 0
    max_cells: List[Tuple[int, int]] = []
    for i in range(1, m + 1):
        for j in range(1, n + 1):
            best, direction = 0, DIR_NONE
            d = scores[i, j - 1] + gap
            if d > best or (not strict and d == best):
                best, direction = d, DIR_DEL
            ins = scores[i - 1, j] + gap
            if ins > best or (not strict and ins == best):
                best, direction = ins, DIR_INS
            a = scores[i - 1, j - 1] + (match if ref[j - 1] == read[i - 1] else mismatch)
            if a > best or (not strict and a == best):
                best, direction = a, DIR_ALIGN
            scores[i, j] = best
            dirs[i, j] = direction
            if best > max_score:
                max_score = int(best)
                max_cells = [(i, j)]
            elif best == max_score:
                max_cells.append((i, j))
    return scores, dirs, int(max_score), max_cells


def traceback_one(
    cell: Tuple[int, int],
    scores: np.ndarray,
    dirs: np.ndarray,
    ref_seq: str,
    read_seq: str,
    gap_char: str = "_",
) -> Site:
    """One optimal alignment traced back from ``cell``."""
    i, j = cell
    beginning = 0
    ref_parts: List[str] = []
    read_parts: List[str] = []
    while scores[i, j] > 0:
        beginning = j
        d = dirs[i, j]
        if d == DIR_ALIGN:
            ref_parts.append(ref_seq[j - 1])
            read_parts.append(read_seq[i - 1])
            i -= 1
            j -= 1
        elif d == DIR_INS:
            ref_parts.append(gap_char)
            read_parts.append(read_seq[i - 1])
            i -= 1
        else:
            ref_parts.append(ref_seq[j - 1])
            read_parts.append(gap_char)
            j -= 1
    return beginning, ("".join(reversed(ref_parts)), "".join(reversed(read_parts)))


def opt_alignments(
    ref_seq: str,
    read_seq: str,
    scoring: ScoringScheme = ScoringScheme(),
    tie_semantics: str = "serial",
) -> Tuple[int, List[Site]]:
    """(max_score, one site per max cell in row-major order) of one pair."""
    scores, dirs, max_score, max_cells = fill_matrices(ref_seq, read_seq, scoring, tie_semantics)
    sites = [
        traceback_one(cell, scores, dirs, ref_seq, read_seq, scoring.gap_char)
        for cell in max_cells
    ]
    return max_score, sites


def align_chars(dirs: np.ndarray, scoring: ScoringScheme = ScoringScheme()) -> np.ndarray:
    """A direction matrix as the scheme's characters ('a'/'i'/'d'/'-' by
    default), for ``io.report.format_matrices``."""
    lut = np.array([scoring.types[3], scoring.types[0], scoring.types[1], scoring.types[2]])
    return lut[dirs]
