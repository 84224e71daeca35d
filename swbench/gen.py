"""Inputs made from the seed: a reference tree shaped by a configuration,
and input files of reads sampled from it by a traffic mix.

Every seed gets the same set of sizes in another order: reference lengths
are the quantiles of the configuration's length law, or the lengths of
its table, read lengths the quantiles of the mix's (a uniform law, or the
tree's own lengths), so two seeds differ in sequence content, in which
reference each read comes from, and in order, not in the amount of work.
"""

from __future__ import annotations

import dataclasses
import math
import os
import statistics
from typing import List

import numpy as np

BASES = np.frombuffer(b"ACGT", np.uint8)
LINE = 80  # bases per line of a reference file, as NCBI writes them
# Under "whole" sampling, the references a read may come from: the shortest
# this many at least as long as it (in the 64 Mbp tree, at most 1% longer).
NEAREST = 8
DELIMITER = ">gi"


def rng(seed: int, *stream: int) -> np.random.Generator:
    """The generator of one stream (the corpus; input file k; the check's
    sample) of a seed."""
    return np.random.default_rng([int(seed) & ((1 << 64) - 1), *stream])


def lognormal_lengths(median: float, mean: float, lo: int, hi: int, total_bp: int) -> np.ndarray:
    """Ascending lengths at the quantiles (k + 1/2) / n of the log-normal
    law of this median and mean, clipped to [lo, hi], n chosen so that
    they sum to about ``total_bp``."""
    sigma = math.sqrt(2.0 * math.log(mean / median))
    inv = statistics.NormalDist(math.log(median), sigma).inv_cdf

    def at(n: int) -> np.ndarray:
        z = np.fromiter((inv((k + 0.5) / n) for k in range(n)), np.float64, n)
        return np.clip(np.rint(np.exp(z)), lo, hi).astype(np.int64)

    n = max(1, round(total_bp / mean))
    for _ in range(4):
        lens = at(n)
        n = max(1, round(n * total_bp / int(lens.sum())))
    return at(n)


def table_lengths(path: str) -> np.ndarray:
    """The ascending lengths of a length table: a CSV file of ``length,count``
    rows under one header line, each length taken ``count`` times."""
    rows = np.loadtxt(path, delimiter=",", skiprows=1, dtype=np.int64, ndmin=2)
    return np.sort(np.repeat(rows[:, 0], rows[:, 1]))


def reference_lengths(cfg: dict) -> np.ndarray:
    """The ascending lengths of the configuration's tree: those of its
    ``length_table`` where it names one (a path that ``spec.config`` makes
    absolute), which sum to ``total_bp``; else the log-normal law of
    ``median_bp`` and ``mean_bp`` on [``min_bp``, ``max_bp``]."""
    if "length_table" in cfg:
        lens = table_lengths(cfg["length_table"])
        if int(lens.sum()) != cfg["total_bp"]:
            raise ValueError(f"the length table sums to {int(lens.sum())} bp, the configuration's total_bp to "
                             f"{cfg['total_bp']}")
        return lens
    return lognormal_lengths(cfg["median_bp"], cfg["mean_bp"], cfg["min_bp"], cfg["max_bp"], cfg["total_bp"])


def uniform_lengths(lo: int, hi: int, n: int) -> np.ndarray:
    """The n quantiles (k + 1/2) / n of the uniform law on [lo, hi]."""
    k = np.arange(n, dtype=np.float64)
    return (lo + np.floor((k + 0.5) * (hi - lo + 1) / n)).astype(np.int64)


@dataclasses.dataclass
class Corpus:
    """A reference tree: base codes 0-3 back to back, each reference's
    offset and length there, its metadata line, and the files."""

    codes: np.ndarray
    offsets: np.ndarray
    lens: np.ndarray
    names: List[str]
    files: List[str]

    def seq(self, k: int) -> np.ndarray:
        return self.codes[self.offsets[k] : self.offsets[k] + self.lens[k]]

    def text(self, k: int) -> str:
        return BASES[self.seq(k)].tobytes().decode("ascii")


def make_corpus(cfg: dict, seed: int, directory: str) -> Corpus:
    """The configuration's reference tree, written under ``directory`` in
    files of about ``file_bp`` base pairs each, lines of LINE bases."""
    g = rng(seed, 1)
    lens = g.permutation(reference_lengths(cfg))
    offsets = np.zeros_like(lens)
    np.cumsum(lens[:-1], out=offsets[1:])
    codes = g.integers(0, 4, int(lens.sum()), dtype=np.uint8)
    names = [f"{DELIMITER}|{100000000 + k}|ref|NM_{k + 1:09d}.1| synthetic RefSeq-shaped transcript {k + 1}"
             for k in range(len(lens))]
    ascii_bases = BASES[codes].tobytes()
    os.makedirs(directory, exist_ok=True)
    files = []
    bounds = np.searchsorted(np.cumsum(lens), np.arange(cfg["file_bp"], int(lens.sum()), cfg["file_bp"]),
                             side="left") + 1
    edges = [0] + [int(b) for b in bounds if 0 < b < len(lens)] + [len(lens)]
    edges = sorted(set(edges))
    for f, (a, b) in enumerate(zip(edges[:-1], edges[1:]), start=1):
        path = os.path.join(directory, f"ref{f:03d}.rna.fna")
        _write_refs(path, ascii_bases, offsets[a:b], lens[a:b], names[a:b])
        files.append(path)
    return Corpus(codes, offsets, lens, names, files)


def _write_refs(path: str, ascii_bases: bytes, offsets: np.ndarray, lens: np.ndarray, names: List[str]) -> None:
    """FASTA records: the metadata line, then the bases in lines of LINE."""
    parts = []
    for name, o, n in zip(names, offsets.tolist(), lens.tolist()):
        parts.append(name.encode("ascii") + b"\n")
        seq = ascii_bases[o : o + n]
        parts.append(b"\n".join([seq[i : i + LINE] for i in range(0, n, LINE)]))
        parts.append(b"\n")
    with open(path, "wb") as f:
        f.write(b"".join(parts))


@dataclasses.dataclass
class ReadsFile:
    """One input file: its path, its reads (codes and text) and the
    reference each read was sampled from."""

    path: str
    reads: List[np.ndarray]
    texts: List[str]
    sources: np.ndarray

    @property
    def read_bp(self) -> int:
        return sum(len(r) for r in self.reads)


def read_lengths(corpus: Corpus, mix: dict) -> np.ndarray:
    """The lengths of a file's reads, the same for every file and seed:
    ``"uniform"``, the quantiles of the uniform law on [read_min_bp,
    read_max_bp]; ``"references"``, the quantiles of the tree's own
    reference lengths of at least read_min_bp (whole transcripts)."""
    n = mix["reads_per_file"]
    if mix["lengths"] == "uniform":
        return uniform_lengths(mix["read_min_bp"], mix["read_max_bp"], n)
    if mix["lengths"] == "references":
        lens = np.sort(corpus.lens[corpus.lens >= mix["read_min_bp"]])
        if not len(lens):
            raise ValueError(f"no reference is as long as {mix['read_min_bp']} bp")
        return lens[((np.arange(n) + 0.5) * len(lens) / n).astype(np.int64)]
    raise ValueError(f"unknown read lengths {mix['lengths']!r}")


def by_bases(sorted_lens: np.ndarray, lens: np.ndarray, lo: np.ndarray, g: np.random.Generator):
    """(index into ``sorted_lens``, offset) of each read: one draw of a
    uniform position among every start in the tree where a read of its
    length fits, that is, of a source among the references at least as
    long (from ``lo``, ascending ``sorted_lens``) with weight
    ``len - read_len + 1``, and a uniform offset in it."""
    # Per read length, the count of starts that fit before each reference
    # from the first long enough, and through the last.
    ends = {n: np.concatenate(([0], np.cumsum(sorted_lens[first:] - n + 1)))
            for n, first in dict(zip(lens.tolist(), lo.tolist())).items()}
    pos = g.integers(0, np.array([ends[n][-1] for n in lens.tolist()], np.int64))
    picked = np.empty_like(lo)
    within = np.empty_like(lo)
    for k, (n, first, p) in enumerate(zip(lens.tolist(), lo.tolist(), pos.tolist())):
        j = int(np.searchsorted(ends[n], p, side="right")) - 1
        picked[k], within[k] = first + j, p - ends[n][j]
    return picked, within


def make_reads_files(corpus: Corpus, mix: dict, seed: int, directory: str, first: int, count: int) -> List[ReadsFile]:
    """Input files ``first`` to ``first + count - 1`` of the mix, each from
    a stream of its own, so that file k is the same however many are made.

    Each read is taken from a source reference at least as long, with
    substitutions at the mix's rate; a metadata line comes first.  Under
    ``"substring"`` sampling the source is any such reference, chosen
    uniformly, and the read sits at a uniform offset in it; under
    ``"whole"`` the source is one of the NEAREST shortest such
    references, chosen uniformly, so that the read is the whole of it but
    for the few bases by which it is longer (cut at a uniform offset);
    under ``"bases"`` the read starts at a uniform position of the whole
    tree among those where it fits (:func:`by_bases`), as reads of an
    assembly cover its contigs in proportion to their length."""
    lengths = read_lengths(corpus, mix)
    by_len = np.argsort(corpus.lens, kind="stable")
    sorted_lens = corpus.lens[by_len]
    if sorted_lens[-1] < lengths.max():
        raise ValueError(f"no reference is as long as a {int(lengths.max())} bp read")
    os.makedirs(directory, exist_ok=True)
    files = []
    for k in range(first, first + count):
        g = rng(seed, 2, k)
        lens = g.permutation(lengths)
        lo = np.searchsorted(sorted_lens, lens, side="left")
        if mix["sampling"] == "bases":
            picked, within = by_bases(sorted_lens, lens, lo, g)
            sources = by_len[picked]
        else:
            if mix["sampling"] == "substring":
                hi = np.full_like(lo, len(sorted_lens))
            elif mix["sampling"] == "whole":
                hi = np.minimum(lo + NEAREST, len(sorted_lens))
            else:
                raise ValueError(f"unknown sampling {mix['sampling']!r}")
            sources = by_len[g.integers(lo, hi)]
            within = g.integers(0, corpus.lens[sources] - lens + 1)
        starts = corpus.offsets[sources] + within
        j = np.arange(int(lens.sum())) - np.repeat(np.cumsum(lens) - lens, lens)
        codes = corpus.codes[np.repeat(starts, lens) + j]
        subs = g.random(codes.size) < mix["substitution_rate"]
        codes[subs] = (codes[subs] + g.integers(1, 4, int(subs.sum()), dtype=np.uint8)) % 4
        reads = np.split(codes, np.cumsum(lens)[:-1])
        texts = [BASES[r].tobytes().decode("ascii") for r in reads]
        path = os.path.join(directory, f"input{k + 1:05d}.fa")
        with open(path, "w") as f:
            f.write(f"{DELIMITER}|reads|{k + 1}\n" + "\n".join(texts) + "\n")
        files.append(ReadsFile(path, reads, texts, sources))
    return files
