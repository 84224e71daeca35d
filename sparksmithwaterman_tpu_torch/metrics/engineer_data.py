"""Synthetic corpora, byte for byte those of
:mod:`sparksmithwaterman_tpu.metrics.engineer_data` for the same seed and
scale.

The four sweeps of the reference's ``metrics.EngineerData``, one factor
varied at a time, as ``swtorch gen`` writes them:

- **read_num** — input files of 20, then 50-1,600 step 50 reads of 80 bp;
- **read_len** — input files of 5 reads of 20-500 bp step 20;
- **ref_num**  — subdirectories ``ref1..refK``, one file each, of 1, 10,
  30, 50, 100, 500, 1,000, 1,500, 2,000, then 4,000-40,000 step 2,000
  sequences of 400 bp;
- **ref_len**  — subdirectories of one sequence each of 1, 5, 10, 20,
  then 50-1,600 step 50 lines of 80 bp.

``scale`` keeps the first ``scale`` share of each sweep's cases (at least
two).  The sweeps draw each sequence with ``rng.choice`` (seeds 0-5, in
the JAX package's order of calls); the RefSeq-shaped corpus, the reads
file and the workloads below draw with the faster :func:`_fast_seq`.
"""

from __future__ import annotations

import os
from typing import List, Sequence

import numpy as np

IN_NAME, IN_EXT = "input", ".fa"
REF_NAME, REF_EXT = "ref", ".rna.fna"
DELIMITER = ">gi"
_ALPHABET = np.array(list("ACGT"))


def _rand_seq(rng: np.random.Generator, length: int) -> str:
    return "".join(rng.choice(_ALPHABET, size=length))


def _write(path: str, text: str) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write(text.strip())


def change_read_num(directory: str, scale: float = 1.0, seed: int = 0) -> List[str]:
    """Input files varying the number of reads: 20, then 50-1,600 step 50."""
    rng = np.random.default_rng(seed)
    counts = [20] + list(range(50, 1625, 50))
    counts = counts[: max(2, int(len(counts) * scale))]
    paths = []
    for k, n in enumerate(counts, start=1):
        path = os.path.join(directory, f"{IN_NAME}{k}{IN_EXT}")
        _write(path, "\n".join(_rand_seq(rng, 80) for _ in range(n)))
        paths.append(path)
    return paths


def change_read_len(directory: str, scale: float = 1.0, seed: int = 1) -> List[str]:
    """Input files varying the read length: 20-500 bp step 20, 5 reads each."""
    rng = np.random.default_rng(seed)
    lengths = list(range(20, 501, 20))
    lengths = lengths[: max(2, int(len(lengths) * scale))]
    paths = []
    for k, length in enumerate(lengths, start=1):
        path = os.path.join(directory, f"{IN_NAME}{k}{IN_EXT}")
        _write(path, "\n".join(_rand_seq(rng, length) for _ in range(5)))
        paths.append(path)
    return paths


def _ref_file(rng: np.random.Generator, num_seqs: int, seq_len: int, start_id: int = 1) -> str:
    parts = []
    for i in range(num_seqs):
        parts.append(f"{DELIMITER}|{REF_NAME}{start_id + i}")
        parts.append(_rand_seq(rng, seq_len))
    return "\n".join(parts)


def change_ref_num(directory: str, scale: float = 1.0, seed: int = 2) -> List[str]:
    """Subdirectories ref1..refK, one file each, varying the number of
    sequences of 400 bp (28 at scale 1)."""
    rng = np.random.default_rng(seed)
    counts = [1, 10, 30, 50, 100, 500, 1000, 1500, 2000] + list(range(4000, 40001, 2000))
    counts = counts[: max(2, int(len(counts) * scale))]
    paths = []
    for k, n in enumerate(counts, start=1):
        path = os.path.join(directory, f"{REF_NAME}{k}", f"{REF_NAME}{k}{REF_EXT}")
        _write(path, _ref_file(rng, n, 400))
        paths.append(path)
    return paths


def change_ref_len(directory: str, scale: float = 1.0, seed: int = 3) -> List[str]:
    """Subdirectories ref1..refK of one sequence each, varying its length:
    1, 5, 10, 20, then 50-1,600 step 50 lines of 80 bp (36 at scale 1, the
    longest 128,000 bp)."""
    rng = np.random.default_rng(seed)
    line_counts = [1, 5, 10, 20] + list(range(50, 1601, 50))
    line_counts = line_counts[: max(2, int(len(line_counts) * scale))]
    paths = []
    for k, lines in enumerate(line_counts, start=1):
        path = os.path.join(directory, f"{REF_NAME}{k}", f"{REF_NAME}{k}{REF_EXT}")
        _write(path, _ref_file(rng, 1, lines * 80))
        paths.append(path)
    return paths


# The constant factor of the ref_num and ref_len sweeps (reads) and of the
# read_num and read_len sweeps (references).
def fixed_input(directory: str, num_reads: int = 5, read_len: int = 80, seed: int = 4) -> str:
    rng = np.random.default_rng(seed)
    path = os.path.join(directory, f"{IN_NAME}1{IN_EXT}")
    _write(path, "\n".join(_rand_seq(rng, read_len) for _ in range(num_reads)))
    return path


def fixed_refs(directory: str, num_seqs: int = 20, seq_len: int = 400, seed: int = 5) -> str:
    rng = np.random.default_rng(seed)
    path = os.path.join(directory, f"{REF_NAME}1{REF_EXT}")
    _write(path, _ref_file(rng, num_seqs, seq_len))
    return path


SWEEPS = {
    "read_num": change_read_num,
    "read_len": change_read_len,
    "ref_num": change_ref_num,
    "ref_len": change_ref_len,
}


def generate(out_dir: str, sweeps: Sequence[str] = tuple(SWEEPS), scale: float = 1.0) -> None:
    """Write the requested sweeps under ``out_dir`` (``swtorch gen``):
    ``input/readNum``, ``input/readLen``, ``testRef/refNum``,
    ``testRef/refLen``, and always the constant factors ``input/ref`` and
    ``testRef/in``."""
    if "read_num" in sweeps:
        change_read_num(os.path.join(out_dir, "input", "readNum"), scale)
    if "read_len" in sweeps:
        change_read_len(os.path.join(out_dir, "input", "readLen"), scale)
    if "ref_num" in sweeps:
        change_ref_num(os.path.join(out_dir, "testRef", "refNum"), scale)
    if "ref_len" in sweeps:
        change_ref_len(os.path.join(out_dir, "testRef", "refLen"), scale)
    fixed_input(os.path.join(out_dir, "input", "ref"))
    fixed_refs(os.path.join(out_dir, "testRef", "in"))


def _fast_seq(rng: np.random.Generator, n: int) -> str:
    table = np.frombuffer(b"ACGT", np.uint8)
    return table[rng.integers(0, 4, size=n)].tobytes().decode()


def refseq_like(
    directory: str,
    total_bp: int,
    *,
    file_bp: int = 2_000_000,
    min_len: int = 500,
    max_len: int = 4000,
    seed: int = 7,
) -> dict:
    """RefSeq-shaped corpus: multi-sequence files of ~``file_bp`` whose
    sequence lengths draw uniformly from [min_len, max_len) (mean ~2,250,
    near RefSeq's 2,160 bp per sequence).  Returns {"ref_bp", "files",
    "seqs"}."""
    rng = np.random.default_rng(seed)
    os.makedirs(directory, exist_ok=True)
    written = 0
    seqs = 0
    fi = 0
    while written < total_bp:
        fi += 1
        parts: List[str] = []
        bp = 0
        while bp < file_bp and written + bp < total_bp:
            n = int(rng.integers(min_len, max_len))
            parts.append(f">gi|{fi}|{len(parts)}|synthetic\n{_fast_seq(rng, n)}")
            bp += n
        with open(os.path.join(directory, f"{REF_NAME}{fi}{REF_EXT}"), "w") as f:
            f.write("\n".join(parts))
        written += bp
        seqs += len(parts)
    return {"ref_bp": written, "files": fi, "seqs": seqs}


def reads_file(
    path: str, num_reads: int, *, min_len: int = 80, max_len: int = 151, seed: int = 11
) -> int:
    """One reads input file with lengths in [min_len, max_len); returns
    the total read bp."""
    rng = np.random.default_rng(seed)
    reads = [_fast_seq(rng, int(n)) for n in rng.integers(min_len, max_len, size=num_reads)]
    _write(path, "\n".join(reads))
    return sum(map(len, reads))


def long_ref_corpus(root: str, total_bp: int = 16_000_000, n_reads: int = 256, seed: int = 9) -> dict:
    """The shard_seq workload (the shape of the JAX package's
    ``experiments/shard_seq_pipeline.py``): references log-uniform from
    8 kb to 1 Mb until ``total_bp`` in ``root/refs/refs1.rna.fna``, and
    ``n_reads`` reads of 80-150 bp in ``root/inputs/input1.fa``.  Returns
    {"ref_bp", "n_refs", "lens", "read_bp"}."""
    rng = np.random.default_rng(seed)
    lens: List[int] = []
    while sum(lens) < total_bp:
        lens.append(int(np.exp(rng.uniform(np.log(8e3), np.log(1e6)))))
    refs_path = os.path.join(root, "refs", f"refs1{REF_EXT}")
    os.makedirs(os.path.dirname(refs_path), exist_ok=True)
    with open(refs_path, "w") as f:
        f.write("\n".join(f">gi|{i}|seqp{i}\n{_fast_seq(rng, n)}" for i, n in enumerate(lens)))
    reads = [_fast_seq(rng, int(n)) for n in rng.integers(80, 151, size=n_reads)]
    reads_path = os.path.join(root, "inputs", "input1.fa")
    os.makedirs(os.path.dirname(reads_path), exist_ok=True)
    with open(reads_path, "w") as f:
        f.write("\n".join(reads))
    return {"ref_bp": sum(lens), "n_refs": len(lens), "lens": lens, "read_bp": sum(map(len, reads))}


def scale_corpus(
    root: str,
    *,
    corpus_bp: int = 64_000_000,
    long_refs: int = 8,
    long_len: int = 131_072,
    num_reads: int = 512,
    seed: int = 0,
) -> dict:
    """The scale workload: a RefSeq-shaped corpus of ``corpus_bp`` under
    ``root/refs/corpus``, one file of ``long_refs`` references of
    ``long_len`` bp under ``root/refs/long`` (so long-reference flushes
    run; no such file when ``long_refs`` is 0), and ``num_reads`` reads of
    80-150 bp in ``root/inputs/input1.fa``.  Returns {"ref_bp", "files",
    "read_bp"}."""
    corpus = refseq_like(os.path.join(root, "refs", "corpus"), corpus_bp, seed=seed)
    rng = np.random.default_rng(seed + 1)
    if long_refs:
        long_path = os.path.join(root, "refs", "long", f"long{REF_EXT}")
        os.makedirs(os.path.dirname(long_path), exist_ok=True)
        with open(long_path, "w") as f:
            f.write("\n".join(f">gi|long|{i}\n{_fast_seq(rng, long_len)}" for i in range(long_refs)))
    read_bp = reads_file(os.path.join(root, "inputs", "input1.fa"), num_reads, seed=seed + 2)
    return {
        "ref_bp": corpus["ref_bp"] + long_refs * long_len,
        "files": corpus["files"] + (1 if long_refs else 0),
        "read_bp": read_bp,
    }
