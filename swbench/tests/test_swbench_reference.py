"""The plain reference against the port's NumPy oracle at small sizes (the
test may import both; the reference imports neither)."""

import numpy as np
import pytest

from sparksmithwaterman_tpu_torch.config import ScoringScheme
from sparksmithwaterman_tpu_torch.core import oracle
from sparksmithwaterman_tpu_torch.io.report import build_report
from swbench.reference import report, smith_waterman as sw

BASES = np.frombuffer(b"ACGT", np.uint8)


def _text(codes):
    return BASES[codes].tobytes().decode()


def _cases(seed, count=24):
    g = np.random.default_rng(seed)
    for _ in range(count):
        ref = g.integers(0, 4, int(g.integers(8, 70)), dtype=np.uint8)
        reads = [g.integers(0, 4, int(g.integers(1, 24)), dtype=np.uint8) for _ in range(5)]
        reads[0] = ref[3:15].copy()  # a planted read, so no best is 0
        reads[1] = np.concatenate([ref[:6], ref[:6]])  # repeats make ties
        yield ref, reads


@pytest.mark.parametrize("tie", ["serial", "distributed"])
def test_sites_equal_the_oracle(tie):
    scheme = ScoringScheme(tie_semantics=tie)
    for ref, reads in _cases(1):
        reads = [r for r in reads if oracle.opt_alignments(_text(ref), _text(r), scheme)[0] > 0]
        best, sites = sw.read_sites(reads, ref, (5, -3, -4), "cpu", tie_semantics=tie)
        for k, read in enumerate(reads):
            want_best, want_sites = oracle.opt_alignments(_text(ref), _text(read), scheme, tie_semantics=tie)
            assert best[k] == want_best
            assert sites[k] == want_sites


def test_first_only_keeps_each_reads_first_max_cell():
    for ref, reads in _cases(2, 8):
        _, sites = sw.read_sites(reads[:2], ref, (5, -3, -4), "cpu")
        _, first = sw.read_sites(reads[:2], ref, (5, -3, -4), "cpu", first_only=True)
        assert first == [s[:1] for s in sites]


@pytest.mark.parametrize("scheme", [(5, -3, -4), (2, -1, -1), (1, -3, -2)])
def test_best_scores_and_totals_equal_the_oracle(scheme):
    g = np.random.default_rng(3)
    refs = [g.integers(0, 4, int(n), dtype=np.uint8) for n in (1, 7, 40, 90, 33)]
    reads = [g.integers(0, 4, int(n), dtype=np.uint8) for n in (1, 12, 30, 5)]
    reads.append(refs[3][10:40].copy())
    got = sw.best_scores(reads, refs, scheme, "cpu")
    s = ScoringScheme(*scheme)
    want = np.array([[oracle.opt_alignments(_text(f), _text(r), s)[0] for f in refs] for r in reads])
    assert np.array_equal(got, want)
    assert np.array_equal(sw.totals(reads, refs, scheme, "cpu"), want.sum(axis=0))


@pytest.mark.parametrize("step_elems, lane_cols", [(300, 1 << 14), (300, 1), (1 << 26, 1), (1 << 26, 70),
                                                   (2000, 100)])
def test_best_scores_in_several_blocks(monkeypatch, step_elems, lane_cols):
    """Chunks, read blocks and lanes of several references, of one, and
    with columns past the last reference."""
    monkeypatch.setattr(sw, "STEP_ELEMS", step_elems)
    monkeypatch.setattr(sw, "LANE_COLS", lane_cols)
    g = np.random.default_rng(4)
    refs = [g.integers(0, 4, int(n), dtype=np.uint8) for n in g.integers(5, 60, 9)]
    reads = [g.integers(0, 4, int(n), dtype=np.uint8) for n in g.integers(3, 20, 7)]
    want = np.array([[oracle.opt_alignments(_text(f), _text(r), ScoringScheme())[0] for f in refs] for r in reads])
    assert np.array_equal(sw.best_scores(reads, refs, (5, -3, -4), "cpu"), want)


def test_winner_sites_and_report_equal_the_ports_report():
    g = np.random.default_rng(5)
    ref = g.integers(0, 4, 60, dtype=np.uint8)
    reads = [ref[5:20].copy(), ref[30:41].copy(), np.concatenate([ref[:4], ref[:4]])]
    _, per_read = sw.read_sites(reads, ref, (5, -3, -4), "cpu")
    sites = sw.winner_sites(per_read)
    want = []
    for read in reads:
        want.extend(oracle.opt_alignments(_text(ref), _text(read), ScoringScheme())[1])
    want.sort(key=lambda s: s[0])
    assert sites == want
    texts = [_text(r) for r in reads]
    best = sum(oracle.opt_alignments(_text(ref), t, ScoringScheme())[0] for t in texts)
    text = build_report(texts, 7, len(texts), best, 12, [((">gi|w", _text(ref)), sites)])
    lines = report.report_lines(texts, 7, best, [(">gi|w", _text(ref), sites)])
    assert report.stripped(text) == lines
    assert report.lines_differing(lines, report.stripped(text)) == 0
    empty = build_report(texts, 7, len(texts), 0, 12, [])
    assert report.stripped(empty) == report.report_lines(texts, 7, 0, [])
