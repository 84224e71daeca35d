"""K1's two forms: the rule that picks the 16-bit form, and the plain
version at the scores where the rule changes its answer.

``cuda_score.k1_form`` takes the s16x2 form (two packed rows per warp in
the 16-bit halves of each register) exactly when every score and
intermediate provably fits int16; the kernels themselves run only on the
card (``chip_smoke.py`` [0], [1]).  Here the plain version, which both
forms compute, is held at those boundary scores against the port's oracle
and the JAX package's row-form recurrence.
"""

import inspect

import numpy as np
import pytest
import torch

from sparksmithwaterman_tpu.ops.recurrence import score_grid as jax_score_grid
from sparksmithwaterman_tpu_torch.config import ScoringScheme
from sparksmithwaterman_tpu_torch.core import oracle
from sparksmithwaterman_tpu_torch.io.fasta import READ_PAD, REF_PAD, encode_batch
from sparksmithwaterman_tpu_torch.ops import cuda_score
from sparksmithwaterman_tpu_torch.ops.packing import pack_reads, read_best

torch.set_num_threads(1)

_BASES = np.array(list("ACGT"))


def _seqs(rng, lens):
    return ["".join(rng.choice(_BASES, size=int(n))) for n in lens]


def _plain_best(reads, refs, m, params):
    """(reads, refs) best scores of K1's plain version, reads packed in
    m-lane rows, refs REF_PAD-padded."""
    packed, start = pack_reads(reads, m, row_multiple=1)
    n = max(map(len, refs))
    out = cuda_score.lane_best_packed_varlen(
        torch.from_numpy(packed), torch.from_numpy(encode_batch(refs, n, REF_PAD)),
        torch.tensor([len(r) for r in refs], dtype=torch.int32), *params,
    )
    return read_best(out, start).numpy()


def _jax_best(reads, refs, params):
    m = max(map(len, reads))
    n = max(map(len, refs))
    return np.asarray(jax_score_grid(encode_batch(reads, m, READ_PAD), encode_batch(refs, n, REF_PAD), *params))


@pytest.mark.parametrize(
    "m, params, form",
    [
        (256, (5, -3, -4), "s16x2"),  # the default scheme on the main path's rows
        (1024, (31, -3, -4), "s16x2"),  # 31 x 1,024 = 31,744 fits
        (1024, (32, -3, -4), "int32"),  # 32 x 1,024 = 32,768 does not
        (1025, (5, -3, -4), "int32"),  # rows wider than one pass run in stripes
        (256, (5, -3, -32768), "s16x2"),
        (256, (5, -3, -32769), "int32"),
        (256, (5, -32769, -4), "int32"),
    ],
)
def test_k1_form_at_the_edges_of_its_rule(m, params, form):
    assert cuda_score.k1_form(m, *params) == form


@pytest.mark.parametrize("match", [31, 32])
def test_plain_scores_a_read_equal_to_its_ref_at_the_boundary(match):
    """A 1,024 bp read against itself scores match x 1,024: 31,744 (the
    s16x2 form's largest at this width) and 32,768 (past int16)."""
    rng = np.random.default_rng(match)
    (read,) = _seqs(rng, [1024])
    params = (match, -3, -4)
    got = _plain_best([read], [read], 1024, params)
    assert got[0, 0] == match * 1024
    assert got[0, 0] == oracle.opt_alignments(read, read, ScoringScheme(*params))[0]
    assert got[0, 0] == _jax_best([read], [read], params)[0, 0]


def test_plain_at_the_most_negative_gap():
    """gap = -32,768, the s16x2 form's edge: reads that score through
    mismatches and indels, every pair against the oracle and JAX."""
    rng = np.random.default_rng(7)
    refs = _seqs(rng, [90, 120, 1, 64])
    reads = _seqs(rng, rng.integers(1, 60, size=12)) + [refs[1][10:70]]
    params = (5, -3, -32768)
    assert cuda_score.k1_form(64, *params) == "s16x2"
    got = _plain_best(reads, refs, 64, params)
    scheme = ScoringScheme(*params)
    want = np.array([[oracle.opt_alignments(ref, read, scheme)[0] for ref in refs] for read in reads])
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, _jax_best(reads, refs, params))


def test_no_public_function_takes_a_form():
    """The form follows from the data alone: no public function of
    ops/cuda_score.py takes it, and the module reads no environment."""
    for name, fn in inspect.getmembers(cuda_score, inspect.isfunction):
        if fn.__module__ == cuda_score.__name__ and not name.startswith("_"):
            assert "form" not in inspect.signature(fn).parameters, name
    assert list(inspect.signature(cuda_score.lane_best_packed_varlen).parameters) == [
        "packed", "refs_u8", "lens", "match", "mismatch", "gap", "offsets", "carry_cols", "longest",
    ]
    assert "environ" not in inspect.getsource(cuda_score)
    # The private entry of the A/B refuses the s16x2 form where the rule does.
    packed, _ = pack_reads(["ACGT"], 1024)
    with pytest.raises(ValueError):
        cuda_score._lane_best_packed_varlen(
            torch.from_numpy(packed), torch.from_numpy(encode_batch(["ACGT"], 4, REF_PAD)),
            torch.tensor([4], dtype=torch.int32), 32, -3, -4, form="s16x2",
        )
