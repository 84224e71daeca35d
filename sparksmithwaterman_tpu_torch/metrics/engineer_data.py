"""Synthetic corpora, byte for byte those of
:mod:`sparksmithwaterman_tpu.metrics.engineer_data` for the same seed:
a RefSeq-shaped reference corpus and a reads input file."""

from __future__ import annotations

import os
from typing import List

import numpy as np

REF_NAME, REF_EXT = "ref", ".rna.fna"


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
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write("\n".join(reads).strip())
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
