"""K2's s16x2 form and column segments, and K8's segments and finish, on the CPU.

``cuda_score.argmax_lane`` takes its s16x2 form (two reads per warp in the
16-bit halves of each register) exactly when ``cuda_score.k1k4_form`` says
every score fits int16, and a launch with few blocks cuts the reference
into column segments (``cuda_score.argmax_segments``), each counting the
cells of the diagonals it owns, merged lane by lane afterwards; the kernels
run only on the card (``chip_smoke.py`` [0], [2]).  Here a plain model of
each segment (the diagonal loop over its columns, counting only its owned
diagonals) and ``cuda_score.argmax_merge_plain`` are held to
``argmax_lane_plain`` and the JAX package's ``pallas_argmax_grid_diag_chunked``
(interpret mode) on the lanes the traceback reads, and a model of the
kernel's 16-bit argmax arithmetic to the plain version on every lane.
K8's plan of whole tiles (``cuda_score.max_cells_segments``) is held by
listing each segment on its own, and its finish's plain version
(``cuda_score.max_cells_finish_plain``) to a row-major sort.  Tolerance 0
throughout: scores, diagonals, counts and cells are integers.
"""

import numpy as np
import pytest
import torch

from sparksmithwaterman_tpu.ops.pallas_score import pallas_argmax_grid_diag_chunked
from sparksmithwaterman_tpu_torch.io.fasta import READ_PAD, REF_PAD, encode_batch
from sparksmithwaterman_tpu_torch.ops import cuda_score

torch.set_num_threads(1)

PARAMS = (5, -3, -4)
_BASES = np.array(list("ACGT"))


def _seqs(rng, lens, bases=_BASES):
    return ["".join(rng.choice(bases, size=int(n))) for n in lens]


def _grid(reads, ref, m):
    return torch.from_numpy(encode_batch(reads, m, READ_PAD)), torch.from_numpy(encode_batch([ref], len(ref), REF_PAD))


def _owned(plan, m, n, s):
    """The local diagonals [lo, hi) segment s of K2's plan owns."""
    stride, _, offset, count = plan
    j0 = s * stride
    return (0 if s == 0 else offset), (m + n - 1 - j0 if s == count - 1 else stride + offset)


def _segment_partials(reads_t, refs_t, params, plan, *, unroll=1, mask=True):
    """(S, R, C, M) partials of K2's segments, each segment the plain
    diagonal loop over its columns from H = 0, its (best, bestd, count)
    over the diagonals it owns, bestd global.  ``unroll``: the loop runs
    its diagonals rounded up to it, as sweep_s16x2 does; ``mask=False``
    counts those extra diagonals too."""
    m, n = reads_t.shape[1], refs_t.shape[1]
    stride, length, _, count = plan
    parts = []
    for s in range(count):
        j0 = s * stride
        lo, hi = _owned(plan, m, n, s)
        seg = refs_t[:, j0 : j0 + length]
        best = torch.zeros((reads_t.shape[0], refs_t.shape[0], m), dtype=torch.int32)
        bestd, cnt = torch.zeros_like(best), torch.zeros_like(best)
        # Columns past the segment's slice read as REF_PAD, as in the kernel.
        seg = torch.nn.functional.pad(seg, (0, -(-hi // unroll) * unroll + m), value=REF_PAD)
        for d, c1 in cuda_score._unpacked_diagonals(reads_t, seg, *params):
            if d >= -(-hi // unroll) * unroll:
                break
            if (lo <= d < hi) or (not mask and d >= lo):
                gt = c1 > best
                eq = (c1 == best) & (best > 0)
                best = torch.where(gt, c1, best)
                bestd = torch.where(gt, d + j0, bestd)
                cnt = torch.where(gt, 1, cnt + eq.to(torch.int32))
        parts.append((best, bestd, cnt))
    return tuple(torch.stack(p) for p in zip(*parts))


def _consumed_equal(got, want):
    """got equals want on the lanes whose best is the read's max (and
    those lanes are the same)."""
    cons = want[0] == want[0].amax(dim=2, keepdim=True)
    assert torch.equal(got[0] == got[0].amax(dim=2, keepdim=True), cons)
    for g, w in zip(got, want):
        assert torch.equal(g[cons], w[cons])


def test_segment_plan_owns_every_diagonal_once():
    """Each segment owns a run of global diagonals, the runs partition [0,
    m + n - 1), and every owned cell of every lane lies at a local column
    >= W - 1 of a segment after the first; one segment where the card is
    full, a reference is short or the signs admit no split."""
    for m, n, params, blocks, sms in ((152, 131_072, PARAMS, 8, 132), (16, 2000, (5, -3, -1), 1, 8),
                                      (152, 950_000, PARAMS, 32, 132), (40, 1500, (2, 0, -1), 1, 16)):
        plan = cuda_score.argmax_segments(m, n, *params, blocks, sms)
        stride, length, offset, count = plan
        w = m + params[0] * m // -params[2]
        assert count > 1 and offset == w + m - 2 and length == stride + offset
        runs = [(s * stride + lo, s * stride + hi) for s in range(count) for lo, hi in [_owned(plan, m, n, s)]]
        assert runs[0][0] == 0 and runs[-1][1] == m + n - 1
        assert all(a[1] == b[0] and a[0] < a[1] for a, b in zip(runs, runs[1:]))
        assert all(lo - (m - 1) >= w - 1 for s in range(1, count) for lo, _ in [_owned(plan, m, n, s)])
        assert all(hi <= length for s in range(count - 1) for _, hi in [_owned(plan, m, n, s)])
    assert cuda_score.argmax_segments(152, 2000, *PARAMS, 250, 132) == (2000, 2000, 0, 1)  # the card is full
    assert cuda_score.argmax_segments(152, 2000, *PARAMS, 1, 132) == (2000, 2000, 0, 1)  # under 4 W a segment
    for params in ((5, -3, 0), (5, 0, 0), (0, -3, -4), (5, 1, -4)):
        assert cuda_score.argmax_segments(16, 50_000, *params, 1, 132) == (50_000, 50_000, 0, 1)
    # Reads wider than one pass split too (the striped s16x2 form), at the same offset.
    wide = cuda_score.argmax_segments(1025, 50_000, *PARAMS, 1, 132)
    assert wide[3] > 1 and wide[2] == 1025 + 5 * 1025 // 4 + 1025 - 2 and wide[1] == wide[0] + wide[2]


def _small_plan(m, n, params, stride):
    """A K2 plan of the given stride at the least exact offset."""
    offset = m + params[0] * m // -params[2] + m - 2
    return stride, stride + offset, offset, max(1, -(-(m + n - 1 - offset) // stride))


def test_segments_merged_equal_plain_on_consumed_lanes():
    """Random reads (with READ_PAD tails) x one reference cut into
    segments: the merge of the segments' partials equals the whole
    diagonal loop on every lane the traceback reads; strides below, near
    and above the offset."""
    rng = np.random.default_rng(1)
    reads = _seqs(rng, rng.integers(3, 13, 6))
    ref = "".join(_seqs(rng, [420]))
    reads_t, refs_t = _grid(reads, ref, 12)
    want = cuda_score.argmax_lane_plain(reads_t, refs_t, *PARAMS)
    _consumed_equal(cuda_score.argmax_lane(reads_t, refs_t, *PARAMS), want)
    for stride in (1, 37, 150):
        plan = _small_plan(12, 420, PARAMS, stride)
        _consumed_equal(cuda_score.argmax_merge_plain(*_segment_partials(reads_t, refs_t, PARAMS, plan)), want)


def test_ties_planted_at_segment_borders():
    """Copies of two 8 bp reads (A, C, G) in a reference of Ts, ending on
    both sides of the segments' owned borders and inside a segment's
    first W - 1 columns (which it underestimates and does not own): every
    copy a cell at the best, counted once, the first one's diagonal kept."""
    m, n = 8, 900
    plan = _small_plan(m, n, PARAMS, 60)
    stride, _, offset, count = plan
    rng = np.random.default_rng(5)
    reads = _seqs(rng, [8, 8], np.array(list("ACG")))
    ref = bytearray(b"T" * n)
    # Global diagonal of a copy ending at column e on the last row: e + 7.
    # Segment s >= 1 owns from diagonal b[s - 1] on; 7 stride + 10 lies in
    # segment 7's first W - 1 columns, its diagonal in segment 6.
    b = [s * stride + offset for s in range(1, count)]
    ends = {0: [b[1] - 8, b[3] - 7, 7 * stride + 10], 1: [b[7] - 8, b[10] - 6]}
    for r, es in ends.items():
        for e in es:
            ref[e - 7 : e + 1] = reads[r].encode()
    reads_t, refs_t = _grid(reads, ref.decode(), m)
    want = cuda_score.argmax_lane_plain(reads_t, refs_t, *PARAMS)
    assert want[0][:, 0, 7].tolist() == [40, 40] and want[2][:, 0, 7].tolist() == [3, 2]
    assert want[1][:, 0, 7].tolist() == [min(ends[0]) + 7, min(ends[1]) + 7]
    parts = _segment_partials(reads_t, refs_t, PARAMS, plan)
    _consumed_equal(cuda_score.argmax_merge_plain(*parts), want)
    assert int((parts[0][:, :, 0, 7] == 40).sum()) == 5  # each in its own segment
    # Segment 7 scores that copy 40 in its own columns 3-10 but does not own it.
    assert 10 < m + PARAMS[0] * m // -PARAMS[2] - 1 and int(parts[0][7, 0, 0, 7]) < 40


def test_padding_diagonals_under_zero_gap_and_mismatch():
    """gap = 0 and mismatch = 0 (k1_form admits both) give one segment.
    The sweep runs its diagonals rounded up to the unroll; their padding
    cells equal a row's best here, so only the mask on the owned diagonals
    keeps the counts of the diagonal loop."""
    rng = np.random.default_rng(11)
    reads = _seqs(rng, rng.integers(4, 11, 5))
    ref = "".join(_seqs(rng, [97]))
    reads_t, refs_t = _grid(reads, ref, 10)
    for params in ((5, 0, 0), (5, -3, 0), (5, 0, -4)):
        if params[2] == 0:
            assert cuda_score.argmax_segments(10, 97, *params, 1, 132) == (97, 97, 0, 1)
        plan = (97, 97, 0, 1)
        want = cuda_score.argmax_lane_plain(reads_t, refs_t, *params)
        masked = cuda_score.argmax_merge_plain(*_segment_partials(reads_t, refs_t, params, plan, unroll=10))
        _consumed_equal(masked, want)
        if params[2] == 0:  # H never falls along a row: the padding cells equal the row's best
            inflated = cuda_score.argmax_merge_plain(
                *_segment_partials(reads_t, refs_t, params, plan, unroll=10, mask=False))
            cons = want[0] == want[0].amax(dim=2, keepdim=True)
            assert (inflated[2][cons] > want[2][cons]).any()


def test_argmax_lane_matches_pallas_interpret():
    """The JAX package's TPU kernel (interpret mode) and the port's plain
    version, whole and merged from segments, on the lanes the traceback
    reads."""
    rng = np.random.default_rng(3)
    reads = _seqs(rng, rng.integers(4, 16, 8))
    ref = "".join(_seqs(rng, [200]))
    reads_t, refs_t = _grid(reads, ref, 16)
    want = tuple(torch.from_numpy(np.array(t)) for t in pallas_argmax_grid_diag_chunked(
        reads_t.numpy(), refs_t.numpy(), *PARAMS, read_block=8, chunk=64, unroll=4, interpret=True))
    _consumed_equal(cuda_score.argmax_lane(reads_t, refs_t, *PARAMS), want)
    merged = cuda_score.argmax_merge_plain(*_segment_partials(reads_t, refs_t, PARAMS, _small_plan(16, 200, PARAMS, 9)))
    _consumed_equal(merged, want)


def test_merge_takes_the_lowest_segment_and_sums_its_ties():
    best = torch.tensor([[5, 0, 3, 7], [5, 0, 4, 7], [2, 0, 4, 7]], dtype=torch.int32)[:, None, None, :]
    bestd = torch.tensor([[10, 0, 11, 12], [20, 0, 21, 22], [30, 0, 31, 32]], dtype=torch.int32)[:, None, None, :]
    count = torch.tensor([[1, 9, 2, 1], [2, 9, 1, 1], [4, 9, 1, 3]], dtype=torch.int32)[:, None, None, :]
    top, first, ties = cuda_score.argmax_merge_plain(best, bestd, count)
    assert top[0, 0].tolist() == [5, 0, 4, 7]
    assert first[0, 0].tolist() == [10, 0, 21, 12]
    assert ties[0, 0].tolist() == [3, 0, 2, 5]


def test_k2_form_rule_and_refusals():
    """K2 takes k1k4_form's form (k1_form's up to 1,024 lanes); s16x2
    where the rule says int32 raises, on
    any device; the CPU runs the plain version and launches nothing;
    reset_launches clears K2_FORMS."""
    reads_t, refs_t = _grid(["ACGT", "GGA"], "TTACGTAA", 8)
    assert cuda_score.k1_form(1024, 31, -3, -4) == "s16x2" and cuda_score.k1_form(1025, 5, -3, -4) == "int32"
    assert cuda_score.k1_form(8, 5, 1, -4) == "int32" and cuda_score.k1_form(1024, 32, -3, -4) == "int32"
    for params in ((5, 1, -4), (5, -3, 1), (4097, -3, -4)):
        with pytest.raises(ValueError, match="K2 cannot take form 's16x2'"):
            cuda_score._argmax_lane(reads_t, refs_t, *params, form="s16x2")
    with pytest.raises(ValueError, match="K2 cannot take form"):
        cuda_score._argmax_lane(reads_t, refs_t, *PARAMS, form="int16")
    cuda_score.K2_FORMS["s16x2"] = 3
    cuda_score.reset_launches()
    got = cuda_score._argmax_lane(reads_t, refs_t, *PARAMS, form="s16x2", split=False)
    for g, w in zip(got, cuda_score.argmax_lane_plain(reads_t, refs_t, *PARAMS)):
        assert torch.equal(g, w)
    assert cuda_score.K2_FORMS == {"s16x2": 0, "int32": 0} and cuda_score.LAUNCHES["argmax_lane"] == 0


def _wrap(x):
    """x as a 16-bit half of a register holds it (two's complement)."""
    return torch.remainder(torch.as_tensor(x) + 32768, 65536) - 32768


def _state16_model(reads_t, refs_t, params, epoch):
    """K2's s16x2 argmax state as the kernel keeps it, one half per lane,
    every value wrapped to 16 bits: per cell t = h - best, gt = relu(min(t,
    1)), ge = relu(min(t + 1, 1)), count = max(count + gt 0x8001 + ge, gt),
    bestd = max(d - ebase + 32769 + gt 0x7FFF, bestd); every ``epoch``
    diagonals the state is merged into the (best, bestd, count) result, as
    the kernel's flush does, and starts again from 0."""
    shape = (reads_t.shape[0], refs_t.shape[0], reads_t.shape[1])
    out = [torch.full(shape, -1, dtype=torch.int64), torch.zeros(shape, dtype=torch.int64),
           torch.zeros(shape, dtype=torch.int64)]
    state = [torch.zeros(shape, dtype=torch.int64) for _ in range(3)]
    ebase = 0

    def flush():
        b, bd, c = state
        c = torch.where(b > 0, c, 0)
        bd = torch.where(b > 0, bd + ebase, 0)
        gt, eq = b > out[0], (b == out[0]) & (b > 0)
        out[1] = torch.where(gt, bd, out[1])
        out[2] = torch.where(gt, c, out[2] + torch.where(eq, c, 0))
        out[0] = torch.maximum(out[0], b)
        for x in state:
            x.zero_()

    for d, c1 in cuda_score._unpacked_diagonals(reads_t, refs_t, *params):
        if d - ebase == epoch:
            flush()
            ebase = d
        h = c1.to(torch.int64)
        best, bestd, count = state
        t = _wrap(h - best)
        gt = t.clamp(max=1).clamp(min=0)
        ge = _wrap(t + 1).clamp(max=1).clamp(min=0)
        state[0] = torch.maximum(best, h)
        state[2] = torch.maximum(_wrap(count + _wrap(gt * 0x8001 + ge)), gt)
        state[1] = torch.maximum(_wrap(_wrap(d - ebase + 32769) + gt * 0x7FFF), bestd)
    flush()
    return tuple(o.to(torch.int32) for o in out)


@pytest.mark.parametrize("case", ["random", "int16 edge"])
def test_16bit_state_model_equals_plain_on_every_lane(case):
    """The kernel's 16-bit arithmetic, epochs included, on every lane;
    "int16 edge": reads equal to the reference at match 4681 (7 x 4681 =
    32767, the rule's edge), where t reaches 32767 and ge wraps."""
    rng = np.random.default_rng(13)
    if case == "random":
        reads, ref, params, epoch = _seqs(rng, rng.integers(3, 17, 9)), "".join(_seqs(rng, [150])), (5, 0, -1), 40
    else:
        ref = "".join(_seqs(rng, [7]))
        reads, params, epoch = [ref, ref[:5] + "T" * 2], (4681, -3, -4), 3
    reads_t, refs_t = _grid(reads, ref, 16 if case == "random" else 7)
    assert cuda_score.k1_form(reads_t.shape[1], *params) == "s16x2"
    got = _state16_model(reads_t, refs_t, params, epoch)
    want = cuda_score.argmax_lane_plain(reads_t, refs_t, *params)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    if case != "random":
        assert int(want[0].max()) == 32767


def test_k8_segments_of_whole_tiles_list_each_column_once():
    """K8's plan: segments of whole 512-column tiles (the stride below W
    where one tile holds the overlap), skip = W - 1, the owned columns a
    partition; each segment listed on its own from H = 0 gives the full
    listing of a random and a repetitive reference."""
    for m, n, params, blocks, sms in ((152, 2000, PARAMS, 13, 132), (152, 131_072, PARAMS, 1, 132),
                                      (300, 20_000, PARAMS, 2, 132), (20, 3000, PARAMS, 1, 16)):
        stride, length, skip = cuda_score.max_cells_segments(m, n, *params, blocks, sms)
        target = -(-n // -(-cuda_score._K8_BLOCKS_PER_SM * sms // blocks))  # the stride of the target's segments
        assert stride < n and length % 512 == 0 and length == stride + skip and length - 512 < target + skip
        assert skip == m + params[0] * m // -params[2] - 1
        spans = cuda_score.owned_columns(n, stride, skip)
        assert spans[0][0] == 0 and spans[-1][1] == n and all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
    assert cuda_score.max_cells_segments(152, 2000, *PARAMS, 528, 132) == (2000, 2000, 0)
    rng = np.random.default_rng(21)
    m, n, params = 10, 1300, (5, -3, -4)
    stride, length, skip = cuda_score.max_cells_segments(m, n, *params, 1, 64)
    assert (stride, length, skip) == (512 - 21, 512, 21)
    for ref in ("".join(_seqs(rng, [n])), ("ACGTTGCA" * 200)[:n]):
        reads = _seqs(rng, rng.integers(4, 11, 4)) + ["ACGTTGCA"]
        reads_t, ref_t = _grid(reads, ref, m)
        ref_t = ref_t[0]
        best = cuda_score.score_grid_row(reads_t, ref_t[None], *params)[:, 0]
        count, cells = cuda_score.max_cells_row(reads_t, ref_t, best, *params, n * m)
        for r in range(len(reads)):
            listed = []
            for k, (lo, hi) in enumerate(cuda_score.owned_columns(n, stride, skip)):
                j0 = k * stride
                _, seg = cuda_score.max_cells_row_plain(reads_t[r : r + 1], ref_t[j0 : j0 + length], best[r : r + 1],
                                                        *params, m * length)
                seg = seg[0][seg[0][:, 0] >= 0]
                keep = (seg[:, 1] + j0 >= lo) & (seg[:, 1] + j0 < hi)
                listed.append(seg[keep] + torch.tensor([0, j0], dtype=torch.int32))
            listed = torch.cat(listed)
            listed = listed[torch.argsort(listed[:, 0].to(torch.int64) * n + listed[:, 1])]
            assert torch.equal(listed, cells[r, : int(count[r])])


def test_finish_plain_sorts_shuffled_slots_row_major():
    """max_cells_finish (its plain version on the CPU): each read's filled slots (shuffled, -1 past
    the count) in row-major order, -1 after; a read of best 0 the cells of
    its plane by arithmetic, count M x N; best < 0 nothing."""
    rng = np.random.default_rng(4)
    m, n, capacity = 6, 9, 16
    cells = torch.full((4, capacity, 2), -1, dtype=torch.int32)
    want = []
    for r, k in enumerate((5, 16, 0, 0)):
        flat = np.sort(rng.choice(m * n, size=k, replace=False))
        want.append(np.stack([flat // n, flat % n], 1))
        shuffled = rng.permutation(want[-1])
        cells[r, :k] = torch.from_numpy(shuffled.astype(np.int32))
    count = torch.tensor([5, 20, 0, 0], dtype=torch.int64)
    best = torch.tensor([7, 9, 0, -1], dtype=torch.int32)
    got_count, got = cuda_score.max_cells_finish(count, cells, best, m, n)
    assert got_count.tolist() == [5, 20, m * n, 0]
    for r in (0, 1):
        assert torch.equal(got[r, : len(want[r])], torch.from_numpy(want[r].astype(np.int32)))
        assert (got[r, len(want[r]) :] == -1).all()
    plane = np.arange(capacity)
    assert torch.equal(got[2], torch.from_numpy(np.stack([plane // n, plane % n], 1).astype(np.int32)))
    assert (got[3] == -1).all()
