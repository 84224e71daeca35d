"""The generators: repeatable from a seed, the same sizes for every seed,
RefSeq's median and mean, reads that sit in their sources."""

import json
import math

import numpy as np
import pytest
from numpy.lib.stride_tricks import sliding_window_view

from swbench import gen

REFSEQ = dict(median_bp=1609, mean_bp=2160, min_bp=80, max_bp=131072)
SMALL = dict(REFSEQ, total_bp=400_000, file_bp=150_000)
MIX = dict(reads_per_file=64, lengths="uniform", read_min_bp=80, read_max_bp=150, sampling="substring",
           substitution_rate=0.01)
WHOLE = dict(reads_per_file=24, lengths="references", read_min_bp=1025, sampling="whole",
             substitution_rate=0.01)


def _parse(path):
    records, name, parts = [], None, []
    for line in open(path).read().splitlines():
        if line.startswith(">"):
            if name is not None:
                records.append((name, "".join(parts)))
            name, parts = line, []
        else:
            parts.append(line)
    records.append((name, "".join(parts)))
    return records


def test_refseq_lengths_keep_the_median_and_mean():
    lens = gen.lognormal_lengths(1609, 2160, 80, 131072, 64_000_000)
    assert abs(float(np.median(lens)) / 1609 - 1) < 0.02
    assert abs(float(lens.mean()) / 2160 - 1) < 0.02
    assert abs(int(lens.sum()) / 64_000_000 - 1) < 0.001
    assert lens.min() >= 80 and lens.max() <= 131072


def test_uniform_lengths_cover_the_range_evenly():
    lens = gen.uniform_lengths(80, 150, 512)
    assert lens.min() == 80 and lens.max() == 150
    counts = np.bincount(lens - 80)
    assert counts.max() - counts.min() <= 1


def test_corpus_repeats_from_a_seed_and_keeps_its_sizes(tmp_path):
    a = gen.make_corpus(SMALL, 2**31 + 5, str(tmp_path / "a"))
    b = gen.make_corpus(SMALL, 2**31 + 5, str(tmp_path / "b"))
    c = gen.make_corpus(SMALL, 2**31 + 6, str(tmp_path / "c"))
    assert np.array_equal(a.codes, b.codes) and np.array_equal(a.lens, b.lens)
    assert [open(p).read() for p in a.files] == [open(p).read() for p in b.files]
    assert not np.array_equal(a.codes[:1000], c.codes[:1000])
    assert sorted(a.lens.tolist()) == sorted(c.lens.tolist())


def test_reference_files_hold_the_corpus(tmp_path):
    corpus = gen.make_corpus(SMALL, 3, str(tmp_path))
    records = [r for path in corpus.files for r in _parse(path)]
    assert len(corpus.files) == 3
    assert [n for n, _ in records] == corpus.names
    assert all(seq == corpus.text(k) for k, (_, seq) in enumerate(records))
    lines = open(corpus.files[0]).read().splitlines()
    assert max(len(line) for line in lines if not line.startswith(">")) == gen.LINE


def test_reads_repeat_and_sit_in_their_sources(tmp_path):
    corpus = gen.make_corpus(SMALL, 9, str(tmp_path / "refs"))
    files = gen.make_reads_files(corpus, MIX, 9, str(tmp_path / "in"), 0, 6)
    again = gen.make_reads_files(corpus, MIX, 9, str(tmp_path / "again"), 0, 2)
    again += gen.make_reads_files(corpus, MIX, 9, str(tmp_path / "again"), 2, 4)
    assert [f.texts for f in files] == [f.texts for f in again]
    assert all(sorted(map(len, f.reads)) == sorted(gen.uniform_lengths(80, 150, 64).tolist()) for f in files)
    subs = total = 0
    for f in files:
        lines = open(f.path).read().splitlines()
        assert lines[0].startswith(gen.DELIMITER) and lines[1:] == f.texts
        for read, src in zip(f.reads, f.sources):
            ref = corpus.seq(src)
            assert len(ref) >= len(read)
            subs += _subs(read, ref)
            total += len(read)
    assert 0.005 < subs / total < 0.015


def _subs(read, ref):
    return int((sliding_window_view(ref, len(read)) != read).sum(axis=1).min())


def test_long_reads_are_whole_transcripts_of_the_tree(tmp_path):
    corpus = gen.make_corpus(dict(SMALL, total_bp=1_000_000), 4, str(tmp_path / "refs"))
    other = gen.make_corpus(dict(SMALL, total_bp=1_000_000), 5, str(tmp_path / "other"))
    eligible = np.sort(corpus.lens[corpus.lens >= 1025])
    lengths = gen.read_lengths(corpus, WHOLE)
    assert np.array_equal(lengths, eligible[((np.arange(24) + 0.5) * len(eligible) / 24).astype(int)])
    assert np.array_equal(lengths, gen.read_lengths(other, WHOLE))
    subs = total = 0
    for f in gen.make_reads_files(corpus, WHOLE, 4, str(tmp_path / "in"), 0, 3):
        assert sorted(map(len, f.reads)) == lengths.tolist()
        for read, src in zip(f.reads, f.sources):
            ref = corpus.seq(src)
            # The source is one of the NEAREST shortest at least as long as the read.
            shorter = int((eligible < len(ref)).sum()) - int((eligible < len(read)).sum())
            assert len(ref) >= len(read) and shorter < gen.NEAREST
            subs += _subs(read, ref)
            total += len(read)
    assert 0.005 < subs / total < 0.015


def test_at_the_configurations_size_a_long_read_is_its_whole_source():
    """In the 64 Mbp tree the 8 shortest references at least as long as a
    long read are at most 1% longer than it."""
    import json
    import os

    with open(os.path.join(os.path.dirname(gen.__file__), "traffic", "long_reads.json")) as f:
        mix = json.load(f)
    with open(os.path.join(os.path.dirname(gen.__file__), "configs", "refseq_rna.json")) as f:
        cfg = json.load(f)
    lens = np.sort(gen.lognormal_lengths(cfg["median_bp"], cfg["mean_bp"], cfg["min_bp"], cfg["max_bp"],
                                         cfg["total_bp"]))
    corpus = gen.Corpus(np.zeros(0, np.uint8), np.zeros_like(lens), lens, [], [])
    reads = gen.read_lengths(corpus, mix)
    longest_source = lens[np.searchsorted(lens, reads) + gen.NEAREST - 1]
    assert (longest_source <= reads * 1.01).all()
    assert reads.min() > 1024


def _table(path, lens):
    """A length table of ``lens`` at ``path``: ``length,count`` rows."""
    values, counts = np.unique(lens, return_counts=True)
    path.write_text("length,count\n" + "".join(f"{v},{c}\n" for v, c in zip(values, counts)))
    return str(path)


def test_a_length_table_of_the_laws_lengths_makes_the_same_tree(tmp_path):
    """A configuration that names a table of the lengths its law gives
    gets the same tree, byte for byte, from the same seed; without a
    table the law's lengths are used, as before."""
    lens = gen.lognormal_lengths(1609, 2160, 80, 131072, 400_000)
    assert np.array_equal(gen.reference_lengths(SMALL), lens)
    table = _table(tmp_path / "lengths.csv", gen.rng(5, 9).permutation(lens))
    with_table = dict(file_bp=150_000, total_bp=int(lens.sum()), length_table=table)
    assert np.array_equal(gen.table_lengths(table), lens)
    a = gen.make_corpus(SMALL, 2**33 + 1, str(tmp_path / "a"))
    b = gen.make_corpus(with_table, 2**33 + 1, str(tmp_path / "b"))
    assert np.array_equal(a.lens, b.lens) and np.array_equal(a.codes, b.codes)
    for x, y in zip(a.files, b.files):
        with open(x, "rb") as fx, open(y, "rb") as fy:
            assert fx.read() == fy.read()


def test_a_length_table_that_misses_total_bp_is_refused(tmp_path):
    table = _table(tmp_path / "lengths.csv", [8192, 8192, 1_048_576])
    assert gen.table_lengths(table).tolist() == [8192, 8192, 1_048_576]
    with pytest.raises(ValueError, match="sums to 1064960 bp"):
        gen.reference_lengths(dict(total_bp=1_064_961, length_table=table))


def test_a_configuration_names_its_table_from_the_root(tmp_path):
    from swbench import spec
    from swbench.tests.conftest import tiny_root

    root = tiny_root(tmp_path)
    table = _table(tmp_path / "swbench" / "configs" / "tiny.lengths.csv", [3000] * 10)
    path = tmp_path / "swbench" / "configs" / "tiny.json"
    cfg = json.loads(path.read_text())
    cfg["length_table"] = "swbench/configs/tiny.lengths.csv"
    path.write_text(json.dumps(cfg))
    bench = spec.load(root)
    got = spec.config(bench, spec.cell(bench, "tiny.x"), root)
    assert got["length_table"] == table
    assert gen.reference_lengths(got).tolist() == [3000] * 10


BASES_MIX = dict(reads_per_file=500, lengths="uniform", read_min_bp=80, read_max_bp=150, sampling="bases",
                 substitution_rate=0.01)


def test_reads_drawn_by_bases_cover_the_tree_in_proportion(tmp_path):
    """On a tree of lengths 1:10:100, over 3,000 reads, each reference's
    share of the reads is within 3 standard errors of its share of the
    starts where a read fits (len - read_len + 1, all but proportional to
    its length); the reads sit in their sources, and file k is the same
    however many files are made."""
    lens = np.array([200_000, 2_000, 20_000], np.int64)
    codes = gen.rng(1, 1).integers(0, 4, int(lens.sum()), dtype=np.uint8)
    corpus = gen.Corpus(codes, np.array([0, 200_000, 202_000]), lens, [], [])
    files = gen.make_reads_files(corpus, BASES_MIX, 2**32 + 9, str(tmp_path / "in"), 0, 6)
    again = gen.make_reads_files(corpus, BASES_MIX, 2**32 + 9, str(tmp_path / "again"), 4, 2)
    assert [f.texts for f in files[4:]] == [f.texts for f in again]
    sources = np.concatenate([f.sources for f in files])
    read_lens = np.concatenate([[len(r) for r in f.reads] for f in files])
    fits = lens[None, :] - read_lens[:, None] + 1
    expected = (fits / fits.sum(axis=1, keepdims=True)).mean(axis=0)
    n = len(sources)
    assert n == 3000
    for k in range(3):
        share = float((sources == k).mean())
        assert abs(share - expected[k]) <= 3 * math.sqrt(expected[k] * (1 - expected[k]) / n), (k, share)
    subs = total = 0
    for read, src in zip(files[0].reads[:100], files[0].sources[:100]):
        subs += _subs(read, corpus.seq(src))
        total += len(read)
    assert 0.004 < subs / total < 0.016


def test_by_bases_places_every_start_where_a_read_fits():
    """Every start of the tree is drawn, each once a position: the
    inverse of the draw is a bijection onto the starts that fit."""
    sorted_lens = np.array([90, 100, 130, 400], np.int64)

    class Counter:
        def integers(self, lo, hi):
            return np.arange(int(hi[0]))

    n = 100
    fits = sum(int(x) - n + 1 for x in sorted_lens if x >= n)
    lens = np.full(fits, n)
    lo = np.searchsorted(sorted_lens, lens, side="left")
    picked, within = gen.by_bases(sorted_lens, lens, lo, Counter())
    pairs = list(zip(picked.tolist(), within.tolist()))
    assert pairs == [(k, o) for k in (1, 2, 3) for o in range(int(sorted_lens[k]) - n + 1)]
