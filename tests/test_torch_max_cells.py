"""K8, the listing of every cell equal to a tied read's best, on the CPU.

``cuda_score.max_cells_row`` takes its plain version for CPU tensors (the
kernel runs only on the card, where ``chip_smoke.py`` [2] and [14] hold it
to that plain version).  Here the plain listing is held to the JAX
package's ``_max_cells_device_batch`` (plain ``lax``, no Pallas) on the
same encoded inputs and to ``core.oracle.fill_matrices``; the callers in
``ops/longseq.py`` to the JAX ``find_max_cells`` and the host scan; and the
plan by which K8 lists each column of a split reference in one segment
(``cuda_score.owned_columns``) by a model that lists each segment on its
own.  Tolerance 0 throughout: counts and cells are integers.
"""

import numpy as np
import pytest
import torch

from sparksmithwaterman_tpu.config import ScoringScheme as JaxScoringScheme
from sparksmithwaterman_tpu.core import oracle
from sparksmithwaterman_tpu.ops import longseq as jax_longseq
from sparksmithwaterman_tpu_torch.io.fasta import READ_PAD, REF_PAD, encode_batch
from sparksmithwaterman_tpu_torch.ops import cuda_score
from sparksmithwaterman_tpu_torch.ops import longseq as torch_longseq

torch.set_num_threads(1)

PARAMS = (5, -3, -4)
_BASES = np.array(list("ACGT"))


def _seqs(rng, lens, bases=_BASES):
    return ["".join(rng.choice(bases, size=int(n))) for n in lens]


def _encode(reads, ref, m):
    return encode_batch(reads, m, READ_PAD), encode_batch([ref], len(ref), REF_PAD)[0]


def _jax_listing(reads_enc, ref_enc, params, capacity):
    best, count, cells = jax_longseq._max_cells_device_batch(
        reads_enc, ref_enc, *(np.int32(p) for p in params), capacity=capacity
    )
    return np.asarray(best), np.asarray(count), np.asarray(cells)


def _listing(reads_enc, ref_enc, best, params, capacity):
    count, cells = cuda_score.max_cells_row(
        torch.from_numpy(reads_enc), torch.from_numpy(ref_enc), torch.from_numpy(best.astype(np.int32)),
        *params, capacity,
    )
    return count.numpy(), cells.numpy()


def _cases():
    rng = np.random.default_rng(31)
    repetitive = "AC" * 150 + "".join(_seqs(rng, [200])) + "ACG" * 60
    return {
        # Low-scoring random reads tie in many cells of a random reference.
        "random": (_seqs(rng, rng.integers(3, 30, 7)), "".join(_seqs(rng, [300])), PARAMS),
        # Repeats against a repetitive reference: hundreds of tied cells.
        "repeats": (["AC" * 40, "ACG" * 20, "A" * 12, "CA" * 9 + "T"], repetitive, PARAMS),
        # gap = -1: wide co-optimal paths.
        "gap_minus_one": (_seqs(rng, rng.integers(5, 20, 5)) + ["AAAA"], "GGCAC" + "CCCA" * 30, (5, -3, -1)),
    }


@pytest.mark.parametrize("case", ["random", "repeats", "gap_minus_one"])
def test_max_cells_row_matches_jax_and_oracle(case):
    reads, ref, params = _cases()[case]
    reads_enc, ref_enc = _encode(reads, ref, 88)
    w_best, w_count, w_cells = _jax_listing(reads_enc, ref_enc, params, 1024)
    count, cells = _listing(reads_enc, ref_enc, w_best, params, 1024)
    np.testing.assert_array_equal(count, w_count)
    np.testing.assert_array_equal(cells, w_cells)
    assert (w_best > 0).all() and (count > 1).any()
    if case == "repeats":
        assert count.max() > 100
    scoring = JaxScoringScheme(*params)
    for k, read in enumerate(reads):
        _, _, best, want = oracle.fill_matrices(ref, read, scoring)
        assert best == w_best[k]
        assert [(i + 1, j + 1) for i, j in cells[k][: count[k]].tolist()] == want


def test_capacity_below_the_count_and_a_best_of_zero():
    """At capacity 3 a read's count runs past its slots: the count and the
    first three cells in row-major order equal the JAX listing.  A read
    that scores 0 (no base in common with the reference) gets every cell
    of its M x N plane, as the JAX listing does."""
    reads, ref, _ = _cases()["repeats"]
    reads = reads + ["TTTT"]
    ref = ref.replace("T", "G")
    reads_enc, ref_enc = _encode(reads, ref, 88)
    w_best, w_count, w_cells = _jax_listing(reads_enc, ref_enc, PARAMS, 3)
    assert w_best[-1] == 0 and w_count[-1] == 88 * len(ref) and (w_count[:-1] > 3).all()
    count, cells = _listing(reads_enc, ref_enc, w_best, PARAMS, 3)
    np.testing.assert_array_equal(count, w_count)
    np.testing.assert_array_equal(cells, w_cells)
    np.testing.assert_array_equal(cells[-1], [[0, 0], [0, 1], [0, 2]])


def test_exact_max_cells_lists_twice_at_most_then_scans_on_the_host(monkeypatch):
    """_exact_max_cells lists once at its capacity, once more for the reads
    past it at the next power of two of their largest count, and scans a
    read past _CAPACITY_CAP on the host: every read equal to the JAX
    find_max_cells (which doubles its capacity and scans on the host past
    its own cap) and to the oracle."""
    monkeypatch.setattr(torch_longseq, "_CAPACITY_CAP", 64)
    monkeypatch.setattr(jax_longseq, "_CAPACITY_CAP", 64)
    calls = []
    real = torch_longseq.max_cells_row
    monkeypatch.setattr(torch_longseq, "max_cells_row",
                        lambda reads, *a: calls.append((reads.shape[0], a[-1])) or real(reads, *a))
    ref = "AC" * 100 + "GGTT" * 10
    reads = ["ACAC", "GGTTGG", "AC" * 8 + "GGTT"]
    reads_enc, ref_enc = _encode(reads, ref, 64)
    best = np.array([oracle.fill_matrices(ref, r)[2] for r in reads], np.int32)
    got = torch_longseq._exact_max_cells(reads_enc, ref_enc, best, PARAMS, "cpu", capacity=4)
    counts = [len(c) for _, c in got]
    assert counts[0] > 64 and 4 < counts[1] <= 64 and counts[2] == 1
    assert calls == [(3, 4), (2, 64)]
    for read, (b, cells) in zip(reads, got):
        want_best, want_cells = jax_longseq.find_max_cells(read, ref, tuple(np.int32(p) for p in PARAMS), capacity=4)
        assert b == want_best
        np.testing.assert_array_equal(cells, np.asarray(want_cells))
        assert [(i + 1, j + 1) for i, j in cells.tolist()] == oracle.fill_matrices(ref, read)[3]


def test_exact_max_cells_on_the_card_lists_past_the_cap_without_the_host(monkeypatch):
    """On the card (here the branch a "cuda" device takes, its tensors kept
    on the CPU) the reads past the first capacity are listed again at their
    own counts, past _CAPACITY_CAP too, in groups under _SLOT_BUDGET, and the
    host scan never runs: 33,993 and 33,992 ties equal the JAX find_max_cells
    (whose host scan lists them) and the host scan."""
    ref = "A" * 34_000 + "CG" * 50
    reads = ["A" * 8, "A" * 9, "CGCG"]
    reads_enc, ref_enc = _encode(reads, ref, 16)
    best = np.array([40, 45, 20], np.int32)
    want = [torch_longseq._max_cells_host(reads_enc[k], ref_enc, *PARAMS) for k in range(3)]
    calls = []
    real = torch_longseq.max_cells_row
    monkeypatch.setattr(torch_longseq, "max_cells_row",
                        lambda reads, *a: calls.append((reads.shape[0], a[-1])) or real(reads, *a))
    monkeypatch.setattr(torch_longseq, "_to", lambda arr, device: torch.from_numpy(np.ascontiguousarray(arr)))
    monkeypatch.setattr(torch_longseq, "_max_cells_host", lambda *a: pytest.fail("the host scan ran on the card"))
    monkeypatch.setattr(torch_longseq, "_SLOT_BUDGET", 50_000)
    got = torch_longseq._exact_max_cells(reads_enc, ref_enc, best, PARAMS, "cuda")
    assert calls == [(3, 1024), (1, 33_992), (1, 33_993)]
    assert [len(c) for _, c in got] == [33_993, 33_992, 49]
    for read, (b, cells), (wb, wc) in zip(reads, got, want):
        assert b == wb
        np.testing.assert_array_equal(cells, wc)
    jb, jc = jax_longseq.find_max_cells(reads[0], ref, tuple(np.int32(p) for p in PARAMS))
    assert jb == got[0][0]
    np.testing.assert_array_equal(np.asarray(jc), got[0][1])


@pytest.mark.parametrize("read", ["TT", "T" * 300])
def test_find_max_cells_of_a_read_that_scores_zero(read):
    """A best of 0 takes no kernel: its count is the M x N plane, listed
    in full where it fits the capacity (as the JAX find_max_cells), and
    past _CAPACITY_CAP the host scan's (0, no cells)."""
    ref = "ACG" * 60
    got_best, got_cells = torch_longseq.find_max_cells(read, ref, PARAMS, device="cpu")
    want_best, want_cells = jax_longseq.find_max_cells(read, ref, tuple(np.int32(p) for p in PARAMS))
    assert got_best == want_best == 0
    np.testing.assert_array_equal(got_cells, np.asarray(want_cells).reshape(-1, 2))
    assert len(got_cells) == (2 * 180 if len(read) == 2 else 0)


def test_a_wrong_best_raises():
    """A read whose listing finds no cell equal to its best > 0 raises
    instead of returning no sites."""
    reads_enc, ref_enc = _encode(["ACGT"], "TTACGTT", 8)
    with pytest.raises(RuntimeError, match="best is wrong"):
        torch_longseq._exact_max_cells(reads_enc, ref_enc, np.array([21], np.int32), PARAMS, "cpu")


def test_find_max_cells_batched_groups_ties_by_width_on_the_card():
    """Tied reads go to K8 in one listing per width tier on the card,
    shortest first; on the CPU in groups under the plain listing's
    budget.  The batched listing of tie-heavy reads equals the JAX one and
    the oracle."""
    reads = ["AC" * 5, "ACG" * 4, "AC" * 40, "CA" * 3, "AC" * 4 + "G", "ACGT" * 30]
    ties = sorted(range(len(reads)), key=lambda k: len(reads[k]))
    assert torch_longseq._tie_groups(ties, reads, 500, "cuda") == [[3], [4, 0, 1], [2], [5]]
    assert torch_longseq._tie_groups(ties, reads, 500, "cpu") == [ties]
    assert torch_longseq._tie_groups(ties, reads, 1 << 26, "cpu") == [[k] for k in ties]
    ref = "AC" * 100 + "ACGT" * 40
    got = torch_longseq.find_max_cells_batched(reads, ref, PARAMS, device="cpu")
    want = jax_longseq.find_max_cells_batched(reads, ref, tuple(np.int32(p) for p in PARAMS), backend="scan")
    for read, (gb, gc), (wb, wc) in zip(reads, got, want):
        assert gb == wb
        np.testing.assert_array_equal(gc.reshape(-1, 2), np.asarray(wc).reshape(-1, 2))
        assert [(i + 1, j + 1) for i, j in gc.tolist()] == oracle.fill_matrices(ref, read)[3]


def _segmented_listing(reads_enc, ref_enc, best, params, stride, length, skip):
    """What K8 lists with the reference cut into segments: each segment
    [k stride, k stride + length) listed from H = 0 at its left edge, on
    its own, keeping the columns ``owned_columns`` gives it; (count,
    row-major cells) per read."""
    n = len(ref_enc)
    parts = [[] for _ in best]
    for k, (lo, hi) in enumerate(cuda_score.owned_columns(n, stride, skip)):
        j0 = k * stride
        seg = np.ascontiguousarray(ref_enc[j0 : j0 + length])
        count, cells = _listing(reads_enc, seg, best, params, reads_enc.shape[1] * len(seg))
        for r in range(len(best)):
            c = cells[r][: count[r]] + [0, j0]
            parts[r].append(c[(c[:, 1] >= lo) & (c[:, 1] < hi)])
    out = []
    for p in parts:
        c = np.concatenate(p) if p else np.empty((0, 2), np.int32)
        out.append(c[np.lexsort((c[:, 1], c[:, 0]))])
    return out


def test_owned_columns_partition_the_reference():
    """Every column of [0, n) in exactly one segment, inside the columns
    the segment covers, for splits of K5's plan and one segment."""
    for m, n, params, blocks, sms in ((16, 2000, (5, -3, -1), 1, 8), (150, 131_072, PARAMS, 2, 132),
                                      (20, 3000, PARAMS, 1, 16), (150, 5000, PARAMS, 264, 132)):
        stride, length, skip = cuda_score.max_cells_segments(m, n, *params, blocks, sms)
        spans = cuda_score.owned_columns(n, stride, skip)
        assert spans[0][0] == 0 and spans[-1][1] == n
        assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
        assert all(k * stride <= lo <= hi <= min(n, k * stride + length) for k, (lo, hi) in enumerate(spans))
        if stride < n:
            assert skip == m + params[0] * m // -params[2] - 1 and length == stride + skip
        else:
            assert spans == [(0, n)] and skip == 0


def test_segments_list_a_tie_across_a_border_once():
    """Two co-optimal alignments with 39 reference gap columns each (a 16
    bp read of A, C and G in two halves, in a reference of Ts; 80 - 39 =
    41 beats either half's 40): one starts at the last column of segment
    0's stride, so segment 1 sees only its right half, the other lies
    inside segment 2.  Listed segment by segment, each column by its one
    owner, the cells equal the unsplit listing and the JAX one.  Without
    the W - 1 offset segment 1 owns the first copy's end, which it
    underestimates, and the listing loses it."""
    rng = np.random.default_rng(8)
    params = (5, -3, -1)
    read = "".join(_seqs(rng, [16], np.array(list("ACG"))))
    m, n = 16, 2000
    stride, length, skip = cuda_score.max_cells_segments(m, n, *params, 1, 8)
    w = m + params[0] * m // -params[2]
    assert (stride, length, skip) == (512 - (w - 1), 512, w - 1)  # one tile a segment
    ref = list("T" * n)
    copy = read[:8] + "T" * 39 + read[8:]
    for start in (stride - 1, 2 * stride + 100):
        ref[start : start + len(copy)] = copy
    ref = "".join(ref)
    reads_enc, ref_enc = _encode([read, read[:8]], ref, m)
    w_best, w_count, w_cells = _jax_listing(reads_enc, ref_enc, params, 64)
    assert w_best.tolist() == [41, 40] and w_count[0] == 2
    count, cells = _listing(reads_enc, ref_enc, w_best, params, 64)
    np.testing.assert_array_equal(cells, w_cells)
    got = _segmented_listing(reads_enc, ref_enc, w_best, params, stride, length, skip)
    for r in range(2):
        np.testing.assert_array_equal(got[r], cells[r][: count[r]])
    assert stride < got[0][0][1] < stride + w - 1  # the first copy ends in segment 1's overlap
    lost = _segmented_listing(reads_enc, ref_enc, w_best, params, stride, length, 0)
    assert len(lost[0]) == 1 and lost[0][0].tolist() == got[0][1].tolist()
