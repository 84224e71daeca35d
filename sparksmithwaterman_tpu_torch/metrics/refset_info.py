"""Reference-dataset statistics.

The port's copy of :mod:`sparksmithwaterman_tpu.metrics.refset_info`
(the reference's ``metrics.RefSetInfo``): crawl a reference directory,
count files, sequences and base pairs, the min, max, mean and median bp
per sequence (the median streamed through :class:`RunningMedian`), and
format the summary with two file tables (by file name and by sequence
count), byte for byte the JAX package's text.
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Tuple

from sparksmithwaterman_tpu_torch.io import get_ref_seqs, iter_files
from sparksmithwaterman_tpu_torch.io.report import write_str_to_file
from sparksmithwaterman_tpu_torch.metrics.running_median import RunningMedian

NEWLINE = "\n"


@dataclasses.dataclass
class RefSetInfo:
    directory: str
    num_files: int
    num_seqs: int
    total_bp: int
    min_bp: int
    max_bp: int
    mean_bp: float
    median_bp: float
    # (filename, num sequences) per file
    files: List[Tuple[str, int]]


def get_info(directory: str, delimiter: str = ">gi") -> RefSetInfo:
    """Crawl ``directory`` and gather its statistics."""
    num_files = 0
    num_seqs = 0
    total_bp = 0
    min_bp = None
    max_bp = None
    median = RunningMedian()
    files: List[Tuple[str, int]] = []
    for path in iter_files(directory):
        num_files += 1
        seqs = get_ref_seqs(path, delimiter)
        files.append((os.path.basename(path), len(seqs)))
        num_seqs += len(seqs)
        for _, seq in seqs:
            bp = len(seq)
            total_bp += bp
            min_bp = bp if min_bp is None else min(min_bp, bp)
            max_bp = bp if max_bp is None else max(max_bp, bp)
            median.add(bp)
    return RefSetInfo(
        directory=directory,
        num_files=num_files,
        num_seqs=num_seqs,
        total_bp=total_bp,
        min_bp=min_bp or 0,
        max_bp=max_bp or 0,
        mean_bp=total_bp / num_seqs if num_seqs else 0.0,
        median_bp=median.median,
        files=files,
    )


def _table(rows: List[Tuple[str, int]]) -> str:
    """The file table: name, then sequence count with thousands separators."""
    parts = [
        f"{'File Name':<35}|{'# Sequences':>11}{NEWLINE}",
        "-----------------------------------+-----------" + NEWLINE,
    ]
    for name, count in rows:
        parts.append(f"{name:<35}|{count:>11,}{NEWLINE}")
    return "".join(parts)


def format_info(info: RefSetInfo) -> str:
    """The full report string."""
    parts = [
        f"directory = {info.directory}{NEWLINE}",
        NEWLINE,
        f"# files  =  {info.num_files}{NEWLINE}",
        f"{'# reference sequences':<21}  =  {info.num_seqs:<11,}{NEWLINE}",
        f"{'# total base pairs':<21}  =  {info.total_bp:<11,}{NEWLINE}",
        NEWLINE,
        "base pairs in a sequence:" + NEWLINE,
        "-------------------------" + NEWLINE,
        f"{'min':<6}  =  {info.min_bp:<10,}{NEWLINE}",
        f"{'max':<6}  =  {info.max_bp:<10,}{NEWLINE}",
        f"{'mean':<6}  =  {info.mean_bp:<7,.2f}{NEWLINE}",
        f"{'median':<6}  =  {info.median_bp:<7,.2f}{NEWLINE}",
        NEWLINE,
        NEWLINE,
        _table(sorted(info.files, key=lambda t: t[0])),
        NEWLINE,
        NEWLINE,
        _table(sorted(info.files, key=lambda t: t[1])),
    ]
    return "".join(parts)


def print_all_info(directory: str, out_file: str, delimiter: str = ">gi") -> RefSetInfo:
    """Write :func:`format_info` of ``directory`` to ``out_file``."""
    info = get_info(directory, delimiter)
    write_str_to_file(out_file, format_info(info))
    return info
