"""The port's read packing against the JAX package's.

This system has no weights: what crosses from one package to the other
is the configuration (``AlignConfig``/``ScoringScheme``, reused by
import) and these packed arrays, so this is the carry-across check.
"""

import numpy as np
import pytest
import torch

from sparksmithwaterman_tpu.ops import packing as jax_packing
from sparksmithwaterman_tpu.ops.pallas_score import _START_BIT
from sparksmithwaterman_tpu_torch.ops import packing as torch_packing

torch.set_num_threads(1)

_BASES = np.array(list("ACGTacgt"))


def _reads(seed, n, lo, hi):
    rng = np.random.default_rng(seed)
    return ["".join(rng.choice(_BASES, size=int(l))) for l in rng.integers(lo, hi, size=n)]


def test_start_bit_matches():
    assert torch_packing.START_BIT == _START_BIT


@pytest.mark.parametrize(
    "reads, m_pack, row_multiple",
    [
        (_reads(0, 40, 80, 151), 256, 8),
        (_reads(1, 25, 1, 129) + ["", ""], 128, 8),
        (_reads(2, 9, 100, 513), 512, 4),
        ([""], 128, 8),
    ],
    ids=["illumina_256", "ragged_with_empty_128", "long_512", "one_empty"],
)
def test_pack_reads_identical(reads, m_pack, row_multiple):
    got = torch_packing.pack_reads(reads, m_pack, row_multiple=row_multiple)
    want = jax_packing.pack_reads(reads, m_pack, row_multiple=row_multiple)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_pack_reads_rejects_long_read():
    with pytest.raises(ValueError):
        torch_packing.pack_reads(["A" * 129], 128)


def test_read_best_and_col_sums_match():
    rng = np.random.default_rng(8)
    lane = rng.integers(0, 2000, size=(5, 16, 128)).astype(np.int32)
    start_idx = rng.choice(16 * 128, size=37, replace=False).astype(np.int32)
    got_best = torch_packing.read_best(torch.from_numpy(lane), start_idx)
    np.testing.assert_array_equal(got_best.numpy(), np.asarray(jax_packing.read_best(lane, start_idx)))
    got_sums = torch_packing.packed_col_sums(torch.from_numpy(lane), start_idx)
    assert got_sums.dtype == torch.int64
    np.testing.assert_array_equal(got_sums.numpy(), np.asarray(jax_packing.packed_col_sums(lane, start_idx)))


def test_col_sums_do_not_wrap_int32():
    lane = torch.full((2, 8, 128), 1 << 30, dtype=torch.int32)
    sums = torch_packing.packed_col_sums(lane, np.arange(8, dtype=np.int32))
    assert sums.tolist() == [8 << 30, 8 << 30]
