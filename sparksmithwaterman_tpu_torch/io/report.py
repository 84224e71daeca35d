"""The result report, byte for byte the format of
:mod:`sparksmithwaterman_tpu.io.report` (the reference's
``InOutOps.GetOutputStr``), and the score and direction matrices of one
pair as text (``InOutOps.PrintMatrices``)."""

from __future__ import annotations

import os
from typing import List, Sequence, Tuple

NEWLINE = "\n"
TAB = "\t"

# A "site" is (beginning_index, (aligned_ref, aligned_read)).
Site = Tuple[int, Tuple[str, str]]
# An "opt" entry is ((metadata, sequence), [sites...]).
OptEntry = Tuple[Tuple[str, str], List[Site]]

# Aligned-read sentinel of a note pseudo-site; NUL never occurs in FASTA
# data, so no real alignment collides with it.
_NOTE_TAG = "\x00note"


def truncation_note(omitted: int) -> Site:
    """A pseudo-site recording that ``omitted`` identical zero-score sites
    were dropped by the degenerate-matrix cap; index 0 and the stable
    site sort keep it last among the (all index-0) degenerate sites."""
    return (0, (f"[{omitted} identical zero-score sites omitted]", _NOTE_TAG))


def build_report(
    reads: Sequence[str],
    num_refs: int,
    num_reads: int,
    max_score: int,
    exec_time_ms: int,
    opt: Sequence[OptEntry],
) -> str:
    """Format the result report."""
    parts: List[str] = []
    parts.append(f"Execution Time = {exec_time_ms} ms{NEWLINE}")
    parts.append(NEWLINE)
    parts.append(f"# Reference Sequences = {num_refs}{NEWLINE}")
    parts.append(f"# Reads = {num_reads}{NEWLINE}")
    parts.append(NEWLINE)
    parts.append(f"Input:{NEWLINE}")
    for read in reads:
        parts.append(f"{read}{NEWLINE}")
    parts.append(NEWLINE)
    parts.append(f"Maximum alignment score = {max_score}")
    parts.append(NEWLINE)
    for (metadata, sequence), sites in opt:
        parts.append(f"Reference:{NEWLINE}")
        parts.append(f"{metadata}{NEWLINE}")
        parts.append(f"{sequence}{NEWLINE}")
        parts.append(NEWLINE)
        for index, (aligned_ref, aligned_read) in sites:
            if aligned_read == _NOTE_TAG:
                parts.append(f"{TAB}{aligned_ref}{NEWLINE}")
                parts.append(NEWLINE)
                continue
            parts.append(f"{TAB}Index = {index}{NEWLINE}")
            parts.append(f"{TAB}{aligned_ref}{NEWLINE}")
            parts.append(f"{TAB}{aligned_read}{NEWLINE}")
            parts.append(NEWLINE)
    return "".join(parts)


def format_matrices(scores, aligns, ref_seq: str, read_seq: str) -> str:
    """The score and alignment-type matrices of one pair as text.

    ``scores`` is an (m+1, n+1) int matrix, ``aligns`` the matching char
    matrix (``core.oracle.align_chars``), ``ref_seq`` the column sequence,
    ``read_seq`` the row sequence.
    """
    parts: List[str] = [NEWLINE, "   _  "]
    for ch in ref_seq:
        parts.append(f"{ch.upper()}  ")
    parts.append(NEWLINE)
    for i in range(len(scores)):
        parts.append("_  " if i == 0 else f"{read_seq[i - 1].upper()}  ")
        for j in range(len(scores[i])):
            score = int(scores[i][j])
            parts.append(f"{score}  " if score < 10 else f"{score} ")
        parts.append(NEWLINE)
    parts.append(NEWLINE)
    parts.append("   _  ")
    for ch in ref_seq:
        parts.append(f"{ch.upper()}  ")
    parts.append(NEWLINE)
    for i in range(len(aligns)):
        parts.append("_  " if i == 0 else f"{read_seq[i - 1].upper()}  ")
        for j in range(len(aligns[i])):
            parts.append(f"{aligns[i][j]}  ")
        parts.append(NEWLINE)
    return "".join(parts)


def write_str_to_file(filepath: str | os.PathLike, data: str) -> bool:
    """Write ``data`` to ``filepath``, creating its parent directory."""
    filepath = os.fspath(filepath)
    parent = os.path.dirname(filepath)
    if parent:
        os.makedirs(parent, exist_ok=True)
    try:
        with open(filepath, "w") as f:
            f.write(data)
        return True
    except OSError:
        return False
