"""The generators: repeatable from a seed, the same sizes for every seed,
RefSeq's median and mean, reads that sit in their sources."""

import numpy as np
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
