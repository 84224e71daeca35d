"""The port's DP recurrence against the JAX package's, on the same inputs.

Integer DP, so every comparison is exact: int32 scores, int8 directions.
"""

import numpy as np
import pytest
import torch

from sparksmithwaterman_tpu.core import oracle
from sparksmithwaterman_tpu.io.fasta import READ_PAD, REF_PAD, encode_batch
from sparksmithwaterman_tpu.ops import recurrence as jax_rec
from sparksmithwaterman_tpu_torch.ops import recurrence as torch_rec

torch.set_num_threads(1)

PARAMS = (5, -3, -4)
_BASES = np.array(list("ACGT"))


def _seqs(rng, lens, alphabet=_BASES):
    return ["".join(rng.choice(alphabet, size=int(l))) for l in lens]


def _cases():
    rng = np.random.default_rng(21)
    mixed = np.array(list("ACGTacgt"))
    return {
        # empty reads and length-1 refs
        "edges": (["", "A", "ACGT"] + _seqs(rng, [7, 12]), ["C", "A"] + _seqs(rng, [1, 30, 25])),
        "mixed_case": (_seqs(rng, [9, 14, 5, 11, 3], mixed), _seqs(rng, [40, 17, 33, 8, 26], mixed)),
        # planted repeats: several co-optimal cells and tied paths
        "tied": (["ACGTACGT", "ACCG", "AAAA", "ACTCG", "GT"], ["TTACGTACGTAATTACGTACGTAA", "ACCACGCCG", "AAAAAAAA", "ACCACGCCG", "GTGTGT"]),
    }


@pytest.mark.parametrize("case", ["edges", "mixed_case", "tied"])
def test_score_pairs_and_grid(case):
    reads, refs = _cases()[case]
    reads_enc = encode_batch(reads, 16, READ_PAD)
    refs_enc = encode_batch(refs, 40, REF_PAD)
    want_pairs = np.asarray(jax_rec.score_pairs(reads_enc, refs_enc, *(np.int32(p) for p in PARAMS)))
    got_pairs = torch_rec.score_pairs(torch.from_numpy(reads_enc), torch.from_numpy(refs_enc), *PARAMS)
    np.testing.assert_array_equal(got_pairs.numpy(), want_pairs)
    want_grid = np.asarray(jax_rec.score_grid(reads_enc, refs_enc, *(np.int32(p) for p in PARAMS)))
    got_grid = torch_rec.score_grid(torch.from_numpy(reads_enc), torch.from_numpy(refs_enc), *PARAMS)
    assert got_grid.dtype == torch.int32
    np.testing.assert_array_equal(got_grid.numpy(), want_grid)
    for r, read in enumerate(reads):
        assert int(got_pairs[r]) == oracle.opt_alignments(refs[r], read)[0]


@pytest.mark.parametrize("tie_semantics", ["serial", "distributed"])
@pytest.mark.parametrize("case", ["edges", "mixed_case", "tied"])
def test_fill_pairs_both_tie_engines(case, tie_semantics):
    reads, refs = _cases()[case]
    reads_enc = encode_batch(reads, 16, READ_PAD)
    refs_enc = encode_batch(refs, 40, REF_PAD)
    h_j, d_j = jax_rec.fill_pairs(
        reads_enc, refs_enc, *(np.int32(p) for p in PARAMS), tie_semantics=tie_semantics
    )
    h_t, d_t = torch_rec.fill_pairs(
        torch.from_numpy(reads_enc), torch.from_numpy(refs_enc), *PARAMS, tie_semantics=tie_semantics
    )
    assert h_t.dtype == torch.int32 and d_t.dtype == torch.int8
    np.testing.assert_array_equal(h_t.numpy(), np.asarray(h_j))
    np.testing.assert_array_equal(d_t.numpy(), np.asarray(d_j))


def test_fill_pairs_broadcasts_one_ref():
    rng = np.random.default_rng(4)
    reads_enc = encode_batch(_seqs(rng, [5, 9, 0]), 16, READ_PAD)
    ref_enc = encode_batch(_seqs(rng, [30]), 32, REF_PAD)
    h1, d1 = torch_rec.fill_pairs(torch.from_numpy(reads_enc), torch.from_numpy(ref_enc), *PARAMS)
    h3, d3 = torch_rec.fill_pairs(
        torch.from_numpy(reads_enc), torch.from_numpy(np.repeat(ref_enc, 3, axis=0)), *PARAMS
    )
    assert torch.equal(h1, h3) and torch.equal(d1, d3)
