"""The port's ``sites_for_pair_long`` (one read against a long reference:
its max cells, then a window filled and walked at each) gives the JAX
package's ``sites_for_pair_long`` and the oracle's sites on the cases of
tests/test_longseq.py, on the CPU; with gap -1 it is held to the oracle
alone, the JAX package's window assuming the default scheme."""

import numpy as np
import pytest

from sparksmithwaterman_tpu.ops import longseq as jax_longseq
from sparksmithwaterman_tpu_torch.config import ScoringScheme
from sparksmithwaterman_tpu_torch.core import oracle
from sparksmithwaterman_tpu_torch.io.report import build_report
from sparksmithwaterman_tpu_torch.ops import longseq
from sparksmithwaterman_tpu_torch.ops.traceback import DEGENERATE_SITE_CAP

PARAMS = (5, -3, -4)
JAX_PARAMS = tuple(np.int32(p) for p in PARAMS)


def _seq(rng, n):
    return "".join(rng.choice(list("ACGT"), size=n))


def _embed(rng, ref_len, read, positions):
    """A random ref with copies of ``read`` planted at ``positions``."""
    ref = list(_seq(rng, ref_len))
    for p in positions:
        ref[p : p + len(read)] = read
    return "".join(ref)


@pytest.mark.parametrize("seed", range(4))
def test_planted_twice_matches_jax_and_oracle(seed):
    rng = np.random.default_rng(100 + seed)
    read = _seq(rng, 12)
    ref = _embed(rng, 600, read, [50, 400])
    got = longseq.sites_for_pair_long(ref, read, PARAMS, device="cpu")
    assert got == jax_longseq.sites_for_pair_long(ref, read, JAX_PARAMS)
    assert got == oracle.opt_alignments(ref, read)[1]
    assert sum(1 for _, (a, b) in got if a == b == read) == 2


@pytest.mark.parametrize("tie_semantics", ["serial", "distributed"])
def test_gapped_read_in_2kb_matches_jax_and_oracle(tie_semantics):
    rng = np.random.default_rng(7)
    read = "ACGTACGTTTACGT"
    ref = _embed(rng, 2000, "ACGTACGTTACGT", [777])  # the read with one base deleted
    got = longseq.sites_for_pair_long(ref, read, PARAMS, tie_semantics=tie_semantics, device="cpu")
    assert got == jax_longseq.sites_for_pair_long(ref, read, JAX_PARAMS, tie_semantics=tie_semantics)
    assert got == oracle.opt_alignments(ref, read, tie_semantics=tie_semantics)[1]
    assert any("_" in a + b for _, (a, b) in got)


def test_precomputed_max_cells_from_either_package():
    rng = np.random.default_rng(22)
    read = _seq(rng, 12)
    ref = _embed(rng, 600, read, [50, 400, 588])
    ours = longseq.find_max_cells(read, ref, PARAMS, device="cpu")
    theirs = jax_longseq.find_max_cells(read, ref, JAX_PARAMS)
    assert ours[0] == theirs[0]
    np.testing.assert_array_equal(ours[1], theirs[1])
    want = oracle.opt_alignments(ref, read)[1]
    assert jax_longseq.sites_for_pair_long(ref, read, JAX_PARAMS, max_cells=theirs) == want
    for cells in (ours, theirs):
        assert longseq.sites_for_pair_long(ref, read, PARAMS, max_cells=cells, device="cpu") == want
    batched = longseq.find_max_cells_batched([read], ref, PARAMS, device="cpu")[0]
    assert longseq.sites_for_pair_long(ref, read, PARAMS, max_cells=batched, device="cpu") == want


def test_degenerate_all_mismatch_long_ref_is_capped():
    ref = "CGT" * 43700  # 131,100 bp, no 'A'
    read = "A" * 128
    got = longseq.sites_for_pair_long(ref, read, PARAMS, device="cpu")
    assert got == jax_longseq.sites_for_pair_long(ref, read, JAX_PARAMS)
    assert len(got) == DEGENERATE_SITE_CAP + 1
    assert got[0] == (0, ("", ""))
    omitted = 128 * 131_100 - DEGENERATE_SITE_CAP
    assert got[-1][1][0] == f"[{omitted} identical zero-score sites omitted]"
    text = build_report([read], 1, 1, 0, 0, [(("m", "s"), got[-1:])])
    assert f"\t[{omitted} identical zero-score sites omitted]\n" in text


def test_short_degenerate_and_empty_pairs_match_jax_and_oracle():
    cases = [("CGTCGT", "AA"), ("ACGT", ""), ("", "ACGT"), ("", "")]
    for ref, read in cases:
        got = longseq.sites_for_pair_long(ref, read, PARAMS, device="cpu")
        assert got == jax_longseq.sites_for_pair_long(ref, read, JAX_PARAMS)
        if ref and read:
            assert got == oracle.opt_alignments(ref, read)[1] == [(0, ("", ""))] * (len(ref) * len(read))
        else:
            assert got == []


def test_gap_minus_one_matches_oracle():
    """Eight matches separated by four deletions each span 36 columns for an
    8 bp read, past the default scheme's 8m/3 + 2 = 23: the port's window
    derives from the scheme (F1 in ROADMAP.md)."""
    scoring = ScoringScheme(gap=-1)
    rng = np.random.default_rng(9)
    read = "A" * 8
    ref = _seq(rng, 300).replace("A", "C") + "GG" + "CCCC".join(read) + "GG" + _seq(rng, 200).replace("A", "T")
    want = oracle.opt_alignments(ref, read, scoring)[1]
    assert max(len(s[1][0]) for s in want) == 36
    got = longseq.sites_for_pair_long(ref, read, scoring.align_scores, ref_bucket=8, device="cpu")
    assert got == want
