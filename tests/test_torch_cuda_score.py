"""The scoring kernels' plain versions against the JAX package's Pallas
kernels (interpret mode, tiny shapes) and the wrappers' device rules.

K1 is held to the TPU kernels at segment START lanes and K2 at lanes
whose best equals the read's max: the only lanes either package's
callers read (the TPU kernels also sweep padding diagonals).
"""

import numpy as np
import pytest
import torch

from sparksmithwaterman_tpu.core import oracle
from sparksmithwaterman_tpu.io.fasta import READ_PAD, REF_PAD, encode_batch
from sparksmithwaterman_tpu.ops import packing as jax_packing
from sparksmithwaterman_tpu.ops.pallas_score import (
    pallas_argmax_grid_diag_chunked,
    pallas_lane_best_packed_multi,
    pallas_lane_best_packed_varlen,
)
from sparksmithwaterman_tpu_torch.io.fasta import encode_concat
from sparksmithwaterman_tpu_torch.ops import cuda_score
from sparksmithwaterman_tpu_torch.ops.packing import pack_reads, read_best

torch.set_num_threads(1)

PARAMS = (5, -3, -4)
_BASES = np.array(list("ACGT"))


def _seqs(rng, lens):
    return ["".join(rng.choice(_BASES, size=int(l))) for l in lens]


def _k1(packed, refs_enc, lens):
    return cuda_score.lane_best_packed_varlen(
        torch.from_numpy(packed), torch.from_numpy(refs_enc),
        torch.as_tensor(np.asarray(lens, np.int32)), *PARAMS,
    )


def _k1_flat(packed, refs, order=None):
    """K1 with the references as one flat buffer read by offset, in
    ``order`` (the backend's longest-first dispatch order)."""
    flat, lens = encode_concat(refs)
    offsets = np.concatenate(([0], np.cumsum(lens)[:-1])).astype(np.int64)
    order = np.arange(len(refs)) if order is None else np.asarray(order)
    return cuda_score.lane_best_packed_varlen(
        torch.from_numpy(packed), torch.from_numpy(flat), torch.from_numpy(lens[order].astype(np.int32)),
        *PARAMS, offsets=torch.from_numpy(offsets[order]),
    )


@pytest.mark.parametrize(
    "m, read_lens, ref_lens, n_pad",
    [
        # ragged reads incl. an empty one; zero-length and length-1 refs
        (128, [10, 64, 0, 33, 45, 7, 1, 60], [17, 0, 96, 1, 40, 128], 128),
        # a 130 bp read forces two-read rows; reads straddle lane 128
        (256, [130, 60, 200, 33, 0], [48, 90, 0], 96),
    ],
    ids=["m128", "m256_straddle"],
)
def test_lane_best_matches_pallas_varlen(m, read_lens, ref_lens, n_pad):
    rng = np.random.default_rng(m)
    reads = _seqs(rng, read_lens)
    refs = _seqs(rng, ref_lens)
    packed, start = pack_reads(reads, m)
    refs_enc = encode_batch(refs, n_pad, REF_PAD)
    got = read_best(_k1(packed, refs_enc, ref_lens), start).numpy()
    lane = pallas_lane_best_packed_varlen(
        packed, refs_enc, ref_lens, *PARAMS, read_block=8, unroll=8, interpret=True
    )
    np.testing.assert_array_equal(got, np.asarray(jax_packing.read_best(lane, start)))
    order = np.argsort(-np.asarray(ref_lens), kind="stable")
    np.testing.assert_array_equal(read_best(_k1_flat(packed, refs, order), start).numpy(), got[:, order])
    for r, read in enumerate(reads):
        for c, ref in enumerate(refs):
            assert got[r, c] == oracle.opt_alignments(ref, read)[0]


def test_lane_best_matches_pallas_multi():
    """The long-ref kernel's contract (uniform n, window streamed in
    chunks on the TPU) is covered by K1 with every length set to n."""
    rng = np.random.default_rng(11)
    reads = _seqs(rng, rng.integers(20, 100, size=10))
    n = 160
    refs = _seqs(rng, [n - 7, n, n - 30, n])
    packed, start = pack_reads(reads, 128)
    refs_enc = encode_batch(refs, n, REF_PAD)
    got = read_best(_k1(packed, refs_enc, [n] * len(refs)), start).numpy()
    lane = pallas_lane_best_packed_multi(
        packed, refs_enc, *PARAMS, read_block=8, cf=2, unroll=8, chunk4=16, interpret=True
    )
    np.testing.assert_array_equal(got, np.asarray(jax_packing.read_best(lane, start)))


def test_argmax_lane_matches_pallas_on_consumed_lanes():
    rng = np.random.default_rng(9)
    reads = _seqs(rng, rng.integers(4, 24, 7)) + ["ACGTACGT"]
    refs = _seqs(rng, [150, 289]) + ["TTACGTACGTAATTACGTACGTAA"]
    reads_enc = encode_batch(reads, 24, READ_PAD)
    refs_enc = encode_batch(refs, 290, REF_PAD)
    got = [
        t.numpy()
        for t in cuda_score.argmax_lane(torch.from_numpy(reads_enc), torch.from_numpy(refs_enc), *PARAMS)
    ]
    want = [
        np.asarray(t)
        for t in pallas_argmax_grid_diag_chunked(
            reads_enc, refs_enc, *PARAMS, read_block=8, chunk=64, unroll=4, interpret=True
        )
    ]
    for r in range(len(reads)):
        for c in range(len(refs)):
            best = want[0][r, c].max()
            lanes = np.flatnonzero(want[0][r, c] == best)
            assert got[0][r, c].max() == best
            np.testing.assert_array_equal(np.flatnonzero(got[0][r, c] == best), lanes)
            if best > 0:
                for g, w in zip(got[1:], want[1:]):
                    np.testing.assert_array_equal(g[r, c, lanes], w[r, c, lanes])


def test_argmax_lane_counts_row_ties():
    """A read planted twice in one DP row: count 2 on that lane."""
    reads_enc = encode_batch(["ACGT"], 8, READ_PAD)
    refs_enc = encode_batch(["ACGTTTACGT"], 10, REF_PAD)
    best, bestd, count = cuda_score.argmax_lane(
        torch.from_numpy(reads_enc), torch.from_numpy(refs_enc), *PARAMS
    )
    assert int(best[0, 0, 3]) == 20 and int(count[0, 0, 3]) == 2
    assert int(bestd[0, 0, 3]) - 3 == 3  # first max cell: row 3, column 3


def test_wrappers_take_plain_path_on_cpu_only():
    cuda_score.reset_launches()
    packed, _ = pack_reads(["ACGT"], 128)
    refs = encode_batch(["ACGTACGT"], 8, REF_PAD)
    _k1(packed, refs, [8])
    cuda_score.argmax_lane(
        torch.from_numpy(encode_batch(["ACGT"], 8, READ_PAD)), torch.from_numpy(refs), *PARAMS
    )
    cuda_score.max_cells_row(
        torch.from_numpy(encode_batch(["ACGT"], 8, READ_PAD)), torch.from_numpy(refs[0]),
        torch.tensor([20], dtype=torch.int32), *PARAMS, 4,
    )
    _, dirs = cuda_score.fill_dirs(
        torch.from_numpy(encode_batch(["ACGT"], 8, READ_PAD)), torch.from_numpy(refs), *PARAMS,
        tie_semantics="serial", want_h=False,
    )
    cuda_score.trace_walk(dirs, torch.tensor([[[3, 3]]], dtype=torch.int32), 8)
    cuda_score.fill_list(torch.from_numpy(encode_batch(["ACGT"], 8, READ_PAD)), torch.from_numpy(refs), *PARAMS,
                         capacity=4, cap=8, tie_semantics="serial")
    cuda_score.fill_walk(torch.from_numpy(encode_batch(["ACGT"], 8, READ_PAD)), torch.from_numpy(refs),
                         torch.tensor([[3, 3]], dtype=torch.int32), *PARAMS, cap=8, tie_semantics="serial")
    assert cuda_score.LAUNCHES == {
        "lane_best_packed_varlen": 0, "argmax_lane": 0, "band_lane_best": 0, "score_grid_diag": 0, "score_grid_row": 0,
        "step_chain_best": 0, "step_variant_best": 0, "max_cells_row": 0, "fill_dirs": 0, "trace_walk": 0,
        "fill_list": 0, "fill_walk": 0,
    }
    with pytest.raises(ValueError):
        cuda_score.lane_best_packed_varlen(
            torch.from_numpy(packed).to(torch.int64), torch.from_numpy(refs),
            torch.tensor([8], dtype=torch.int32), *PARAMS,
        )
    with pytest.raises(ValueError):
        cuda_score.lane_best_packed_varlen(
            torch.from_numpy(packed).to("meta"), torch.from_numpy(refs).to("meta"),
            torch.tensor([8], dtype=torch.int32, device="meta"), *PARAMS,
        )


@pytest.mark.gpu
def test_kernels_match_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    dev = torch.device("cuda")
    rng = np.random.default_rng(2)
    reads = _seqs(rng, rng.integers(1, 151, size=64)) + [""]
    ref_lens = [0, 1, 500, 2100, 4000]
    packed, start = pack_reads(reads, 256)
    refs = _seqs(rng, ref_lens)
    args = [
        torch.from_numpy(packed).to(dev),
        torch.from_numpy(encode_batch(refs, 4000, REF_PAD)).to(dev),
        torch.tensor(ref_lens, dtype=torch.int32, device=dev),
    ]
    k = cuda_score.lane_best_packed_varlen(*args, *PARAMS)
    p = cuda_score.lane_best_packed_varlen_plain(*args, *PARAMS)
    assert torch.equal(read_best(k, start), read_best(p, start))
    flat, lens = encode_concat(refs)
    offsets = torch.from_numpy(np.concatenate(([0], np.cumsum(lens)[:-1]))).to(dev)
    k = cuda_score.lane_best_packed_varlen(
        args[0], torch.from_numpy(flat).to(dev), args[2], *PARAMS, offsets=offsets
    )
    assert torch.equal(read_best(k, start), read_best(p, start))
    reads_enc = torch.from_numpy(encode_batch(reads[:16], 152, READ_PAD)).to(dev)
    ref = torch.from_numpy(encode_batch(_seqs(rng, [3000]), 3000, REF_PAD)).to(dev)
    for a, b in zip(cuda_score.argmax_lane(reads_enc, ref, *PARAMS), cuda_score.argmax_lane_plain(reads_enc, ref, *PARAMS)):
        assert torch.equal(a, b)
