"""Threaded reference-dataset statistics.

The port's copy of :mod:`sparksmithwaterman_tpu.metrics.threaded_refset_info`:
the FASTA parse of each file runs on a thread pool (it is I/O- and
C-parser-bound, so threads overlap under the interpreter lock), the
results are read in the crawler's order, and the statistics equal the
serial :func:`..refset_info.get_info`.  Two-heap states do not merge, so
the median is taken exactly from every file's length array at the end.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import List, Tuple

import numpy as np

from sparksmithwaterman_tpu_torch.io import get_ref_seqs, iter_files
from sparksmithwaterman_tpu_torch.io.report import write_str_to_file
from sparksmithwaterman_tpu_torch.metrics.refset_info import RefSetInfo, format_info


def _file_stats(path: str, delimiter: str) -> Tuple[str, int, np.ndarray]:
    seqs = get_ref_seqs(path, delimiter)
    lengths = np.asarray([len(seq) for _, seq in seqs], dtype=np.int64)
    return os.path.basename(path), len(seqs), lengths


def get_info_threaded(directory: str, delimiter: str = ">gi", workers: int = 8) -> RefSetInfo:
    """Crawl ``directory`` with a pool of ``workers`` threads; the same
    result as ``get_info``.  Files are submitted and their results read in
    the crawler's sorted order, so the file table does not depend on the
    threads' schedule."""
    paths = list(iter_files(directory))
    files: List[Tuple[str, int]] = []
    all_lengths: List[np.ndarray] = []
    with ThreadPoolExecutor(max_workers=max(1, workers)) as pool:
        for name, count, lengths in pool.map(lambda p: _file_stats(p, delimiter), paths):
            files.append((name, count))
            all_lengths.append(lengths)
    lengths = np.concatenate(all_lengths) if all_lengths else np.zeros((0,), np.int64)
    num_seqs = int(lengths.size)
    total_bp = int(lengths.sum())
    return RefSetInfo(
        directory=directory,
        num_files=len(paths),
        num_seqs=num_seqs,
        total_bp=total_bp,
        min_bp=int(lengths.min()) if num_seqs else 0,
        max_bp=int(lengths.max()) if num_seqs else 0,
        mean_bp=total_bp / num_seqs if num_seqs else 0.0,
        median_bp=float(np.median(lengths)) if num_seqs else 0.0,
        files=files,
    )


def print_all_info_threaded(directory: str, out_file: str, delimiter: str = ">gi", workers: int = 8) -> RefSetInfo:
    """Write :func:`format_info` of ``directory``, crawled on threads, to ``out_file``."""
    info = get_info_threaded(directory, delimiter, workers)
    write_str_to_file(out_file, format_info(info))
    return info
