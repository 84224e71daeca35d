"""K3's and K8's 16-bit forms past one pass, and their column pieces, on the CPU.

Past ONE_PASS_LANES lanes ``cuda_score.band_lane_best`` (K3) takes the
s16x2 form where ``cuda_score.k3_form`` says so, a read bounded by the
pack's longest read (``longest=``) or by the row's width, and
``cuda_score.max_cells_row`` (K8) where ``cuda_score.k5_form`` does (its
recurrence is K5's row scan); both cut a long reference into column pieces
(``band_segments``, ``max_cells_segments``) at any width.  The kernels run
only on the card (``chip_smoke.py`` [0], [14]).  Here
:func:`_band_wide_model` computes what ``band_wide_s16x2_kernel``
computes: stripes of 256 lanes, every value a 16-bit half wrapped after
each add, the left column entering each stripe's lanes in piece 0, the
right column leaving in the last piece, the stripe carry one value a
column of the piece; it is chained over segments and held to the JAX row
recurrence (``sparksmithwaterman_tpu.ops.recurrence.score_grid``).
:func:`_cells_wide_model` computes what ``max_cells_wide_s16x2_kernel``
lists: a pair of reads in the halves of a word, tiles of 512 columns, the
carried column one word a row, each column segment from H = 0 at its
left edge listing the columns it owns (the kernel runs a pair's tiles on
four warps a few rows apart, which changes when a row of a tile is
computed, not its values); it is held to the JAX package's
``_max_cells_device_batch``.  Tolerance 0 throughout: scores, counts and
cells are integers.
"""

import numpy as np
import pytest
import torch

from sparksmithwaterman_tpu.io.fasta import READ_PAD as JAX_READ_PAD
from sparksmithwaterman_tpu.io.fasta import REF_PAD as JAX_REF_PAD
from sparksmithwaterman_tpu.io.fasta import encode_batch as jax_encode_batch
from sparksmithwaterman_tpu.ops import longseq as jax_longseq
from sparksmithwaterman_tpu.ops.recurrence import score_grid as jax_score_grid
from sparksmithwaterman_tpu_torch.io.fasta import READ_PAD, REF_PAD, encode_batch, encode_concat
from sparksmithwaterman_tpu_torch.ops import cuda_score
from sparksmithwaterman_tpu_torch.ops.packing import START_BIT, pack_reads

torch.set_num_threads(1)

PARAMS = (5, -3, -4)
_BASES = np.array(list("ACGT"))


def _seqs(rng, lens, bases=_BASES):
    return ["".join(rng.choice(bases, size=int(n))) for n in lens]


def _mutated(rng, seq, rate=1 / 30):
    arr = np.array(list(seq))
    hit = rng.random(arr.size) < rate
    arr[hit] = rng.choice(_BASES, size=int(hit.sum()))
    return "".join(arr)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _s16(x):
    return (np.asarray(x, np.int64) + 32768) % 65536 - 32768


# -- K3 ---------------------------------------------------------------------------


def _segment(refs, segs, k):
    """(flat, offsets, seg_lens, ns) of segment k of ``segs`` of every ref."""
    flat, lens = encode_concat(refs)
    offsets = np.concatenate(([0], np.cumsum(lens)[:-1])).astype(np.int64)
    ns = np.maximum(1, -(-lens // segs)).astype(np.int32)
    seg_lens = np.clip(lens - k * ns, 0, ns).astype(np.int32)
    return flat, np.where(seg_lens > 0, offsets + k * ns, 0).astype(np.int64), seg_lens, ns


def _band_wide_model(packed, flat, offsets, seg_lens, ns, bnd, match, mismatch, gap, *, plan=(0, 0),
                     stripe=cuda_score.STRIPE16_LANES, unroll=8):
    """(lane_best, bnd_out, carry_free) as band_wide_s16x2_kernel computes
    them: each segment cut into the pieces of ``plan`` (stride, back; (0,
    0) one piece), each piece's rows swept stripe by stripe, its local
    diagonals (lanes + width - 1, rounded up to ``unroll``) a 16-bit
    recurrence (values wrapped after every add).  In piece 0, stripe
    lane k's state becomes bnd before local diagonal k and lane 0's NW term
    starts at bnd of the lane above it; lane 0's N term is the stripe
    above's last lane at the same column of the piece (0 past its width
    and in the first stripe), dropped where the lane starts a read.  In
    the last piece lane k's value on local diagonal k + width - 1 leaves
    as bnd_out.  The pieces' lane bests meet by max, then the segmented
    suffix max.  ``carry_free``: no IMAD sum U + (match - mismatch), as an
    unsigned half, passed 0xFFFF."""
    rows, m = packed.shape
    read = (packed & (START_BIT - 1)).astype(np.int64)
    keep = ~((packed >= START_BIT) | (np.arange(m) == 0))
    best = np.zeros((len(ns), rows, m), np.int64)
    bnd_out = np.zeros_like(best)
    carry_free = True
    for c in range(len(ns)):
        n_c = max(int(ns[c]), 1)
        pieces = cuda_score.band_pieces(n_c, *plan) if plan[0] else [(0, n_c)]
        for k, (j0, j1) in enumerate(pieces):
            width = j1 - j0
            length = min(max(int(seg_lens[c]) - j0, 0), width)
            seg = np.append(flat[offsets[c] + j0 : offsets[c] + j0 + length], REF_PAD).astype(np.int64)
            first, last = k == 0, k + 1 == len(pieces)
            above = np.zeros((rows, width), np.int64)  # the stripe above's last lane, per column
            for i0 in range(0, m, stripe):
                lanes = min(stripe, m - i0)
                lane = np.arange(lanes)
                rd, kp = read[:, i0 : i0 + lanes], keep[:, i0 : i0 + lanes]
                h = np.zeros((rows, lanes), np.int64)
                u = np.zeros_like(h)
                if first and i0:
                    u[:, 0] = bnd[c, :, i0 - 1] * kp[:, 0]
                below = np.zeros_like(above)
                for d in range(-(-(lanes + width - 1) // unroll) * unroll):
                    if first and d < lanes:
                        h[:, d] = bnd[c, :, i0 + d]
                    top = above[:, d] if d < width else np.zeros(rows, np.int64)
                    up = np.concatenate([top[:, None], h[:, :-1]], 1) * kp
                    j = d - lane
                    col = seg[np.where((j >= 0) & (j < length), j, length)]
                    v = (rd == col[None]) * (match - mismatch) + u % 65536
                    carry_free &= int(v.max()) <= 0xFFFF
                    h_new = np.maximum(np.maximum(_s16(v + mismatch), _s16(np.maximum(up, h) + gap)), 0)
                    best[c, :, i0 : i0 + lanes] = np.maximum(best[c, :, i0 : i0 + lanes], h_new)
                    if 0 <= d - (lanes - 1) < width:
                        below[:, d - (lanes - 1)] = h_new[:, lanes - 1]
                    if last and 0 <= d - (width - 1) < lanes:
                        bnd_out[c, :, i0 + d - (width - 1)] = h_new[:, d - (width - 1)]
                    u, h = up, h_new
                above = below
    start = torch.from_numpy(packed >= START_BIT)
    return cuda_score.segmented_suffix_max(torch.from_numpy(best), start), torch.from_numpy(bnd_out), carry_free


def _starts(lane, packed):
    """lane (C, ROWS, M) at each read's START lane (lane 0 of a row too)."""
    start = torch.from_numpy((packed >= START_BIT) | (np.arange(packed.shape[1]) == 0))
    return lane[:, start]


def test_k3_form_past_one_pass_with_and_without_longest():
    """k3_form's rule past ONE_PASS_LANES: match x (2L - 1) <= 32,767, L
    the row's width or, given, min(width, longest), with mismatch < 0 and
    gap < 0 (the stripes); unchanged, and blind to ``longest``, up to one
    pass."""
    form = cuda_score.k3_form
    assert form(1025, *PARAMS) == form(2048, *PARAMS) == "s16x2"  # 5 x 4,095 = 20,475
    assert form(4096, *PARAMS) == "int32" and form(16384, *PARAMS, longest=3277) == "s16x2"
    assert form(4096, *PARAMS, longest=3277) == "s16x2"  # 5 x 6,553 = 32,765
    assert form(4096, *PARAMS, longest=3278) == "int32"  # 5 x 6,555 = 32,775
    assert form(4096, 31, -3, -4, longest=529) == "s16x2" and form(4096, 32, -3, -4, longest=529) == "int32"
    assert form(2048, 5, 0, -4) == form(2048, 5, -3, 0) == "int32"  # the stripes need mismatch, gap < 0
    assert form(2048, 5, -32768, -32768) == "s16x2" and form(2048, 5, -32769, -4) == "int32"
    assert form(2048, *PARAMS, longest=10**6) == "s16x2" and form(2048, 9, -3, -4, longest=0) == "s16x2"
    assert form(1024, 16, -3, -4, longest=1) == "s16x2" and form(1024, 17, -3, -4, longest=1) == "int32"
    assert form(256, 5, 0, -4) == "s16x2"  # one pass: no stripes, mismatch 0 allowed


def test_k8_takes_k5_form_at_any_width():
    """K8's rule is K5's (its row scan has no stripes): s16x2 where match x
    m <= 32,767 at any width (6,553 positions at match 5), and the private
    entry refuses the 16-bit form past it."""
    assert cuda_score.k5_form(6553, *PARAMS) == "s16x2" and cuda_score.k5_form(6554, *PARAMS) == "int32"
    rng = np.random.default_rng(1)
    (ref,) = _seqs(rng, [6])
    refs = torch.from_numpy(encode_batch([ref], 6, REF_PAD))[0]
    best = torch.tensor([10], dtype=torch.int32)
    for m, ok in ((6553, True), (6554, False)):
        reads = torch.from_numpy(encode_batch([ref[:4]], m, READ_PAD))
        if ok:
            for got, want in zip(cuda_score._max_cells_row(reads, refs, best, *PARAMS, 4, form="s16x2"),
                                 cuda_score.max_cells_row_plain(reads, refs, best, *PARAMS, 4)):
                np.testing.assert_array_equal(got, want)
        else:
            with pytest.raises(ValueError, match="cannot take form"):
                cuda_score._max_cells_row(reads, refs, best, *PARAMS, 4, form="s16x2")


@pytest.mark.parametrize("m, longest, params", [(1025, 150, PARAMS), (2100, 200, PARAMS), (1100, 60, (5, -3, -1))])
def test_k3_wide_model_in_pieces_chained_matches_jax(m, longest, params):
    """Rows of 1,025-2,100 lanes, reads of up to ``longest`` bp across the
    stripe borders, two segments of a reference long enough that the plan
    (``longest`` given, a small card) cuts each into pieces: the model in
    pieces equals the plain version at every start lane and bnd_out lane
    of each segment (the second from the first's right column), carries
    nothing between halves, and chained equals the JAX row recurrence on
    the whole reference."""
    rng = np.random.default_rng(m)
    (genome,) = _seqs(rng, [2 * 2000 + 4 * 300])
    reads = [_mutated(rng, genome[o : o + n]) for o, n in zip(rng.integers(0, 4000, 40), rng.integers(1, longest, 40))]
    reads += [genome[1990 : 1990 + longest], ""]  # one across the segments' border
    packed, start = pack_reads(reads, m, row_multiple=2)
    lane0 = start % m
    assert (lane0 // 256 != (lane0 + np.maximum(1, [len(r) for r in reads]) - 1) // 256).sum() >= 3
    assert cuda_score.k3_form(m, *params, longest=longest) == "s16x2"
    ref = genome[:4000]
    plan = cuda_score.band_segments(m, 2000, 1, 1, *params, 2, longest=longest)
    w = longest + params[0] * longest // -params[2]
    assert plan[1] == w - 1 and 2 <= len(cuda_score.band_pieces(2000, *plan)) <= 4
    left = np.zeros((1,) + packed.shape, np.int32)
    got = None
    for k in range(2):
        flat, offs, seg_lens, ns = _segment([ref], 2, k)
        args = (_t(packed), _t(flat), _t(offs), _t(seg_lens), _t(ns), _t(left))
        want_lane, want_bout = cuda_score.band_lane_best_plain(*args, *params)
        lane, bout, carry_free = _band_wide_model(packed, flat, offs, seg_lens, ns, left, *params, plan=plan)
        assert carry_free
        np.testing.assert_array_equal(_starts(lane, packed), _starts(want_lane, packed))
        np.testing.assert_array_equal(bout, want_bout)
        left = bout.numpy().astype(np.int32)
        got = lane.reshape(-1) if got is None else torch.maximum(got, lane.reshape(-1))
    want = np.asarray(jax_score_grid(jax_encode_batch(reads, longest, JAX_READ_PAD),
                                     jax_encode_batch([ref], len(ref), JAX_REF_PAD), *(np.int32(p) for p in params)))
    np.testing.assert_array_equal(got[start].numpy(), want[:, 0])


def test_k3_wide_model_at_the_rules_edge_with_the_largest_left_column():
    """Rows of 1,056 lanes (five stripes), reads of at most 529 bp, the
    left column at the contract's largest (match x 529) on every lane, a
    read whose lanes 1-528 equal the segment's columns 0-527 (so across a
    stripe border, at 529 > 256 lanes): at match 31 (31 x 1,057 = 32,767, inside the rule)
    the 16-bit model equals the plain version, a cell reaches 32,767 and
    no IMAD carries; at 32, just outside, the model wraps."""
    rng = np.random.default_rng(31)
    (seg,) = _seqs(rng, [600], np.array(list("ACG")))
    edge = "T" + seg[:528]
    reads = ["A" * 200, edge] + _seqs(rng, rng.integers(1, 530, 4)) + ["T"]
    packed, _ = pack_reads(reads, 1056, row_multiple=2)
    for match, fits in ((31, True), (32, False)):
        params = (match, -3, -4)
        assert (cuda_score.k3_form(1056, *params, longest=529) == "s16x2") == fits
        bnd = np.full((1,) + packed.shape, match * 529, np.int32)
        flat, offs, seg_lens, ns = _segment([seg], 1, 0)
        args = (_t(packed), _t(flat), _t(offs), _t(seg_lens), _t(ns), _t(bnd))
        want_lane, want_bout = cuda_score.band_lane_best_plain(*args, *params)
        lane, bout, carry_free = _band_wide_model(packed, flat, offs, seg_lens, ns, bnd, *params)
        top = int(_starts(want_lane, packed).max())
        if fits:
            assert top == 32767 and carry_free
            np.testing.assert_array_equal(_starts(lane, packed), _starts(want_lane, packed))
            np.testing.assert_array_equal(bout, want_bout)
        else:
            assert top == 32 * 1057
            assert int(_starts(lane, packed).max()) != top


# -- K8 ---------------------------------------------------------------------------


def _addmax_relu(a, b, c):
    """__viaddmax_s16x2_relu on one 16-bit half: max(a + b wrapped, c, 0)."""
    return np.maximum(np.maximum(_s16(a + b), c), 0)


def _shift_lanes(x, s, fill):
    """__shfl_up_sync by s over the lane axis (-2): lanes below s get fill."""
    out = np.roll(x, s, axis=-2)
    out[..., :s, :] = fill[..., :s, :] if np.ndim(fill) else fill
    return out


def _cells_wide_model(reads, ref, best, match, mismatch, gap, capacity, plan):
    """(count, cells) as max_cells_wide_s16x2_kernel lists them under the
    segment plan (stride, length, skip), every segment at once: each
    read's values one 16-bit half (reads 2p and 2p + 1 share a word, so
    the substitution's multiply-add U + eq x (match - mismatch) of the low
    half must not pass 0xFFFF); each segment from H = 0 at its left edge,
    every row up to the pair's longer read of a tile of 512 columns (32
    lanes x 16) before the next, the carried column one value a row; the
    recurrence and the decaying scan in DPX steps, the scan's steps
    across lanes gap x 16 x 2^q clamped at -32,768; after each row the
    cells equal to a read's best in the columns its segment owns
    (``owned_columns``) listed, then sorted row-major as the finish sorts
    them."""
    r, m = reads.shape
    n = ref.shape[0]
    stride, length, skip = plan
    owned = np.array(cuda_score.owned_columns(n, stride, skip))
    segs = len(owned)
    j0 = np.arange(segs) * stride
    span = np.minimum(length, n - j0)
    rd = reads.astype(np.int64)
    last = np.array([1 + max(np.flatnonzero(row != READ_PAD), default=-1) for row in rd])
    used = np.maximum(last, last[np.minimum(np.arange(r) ^ 1, r - 1)])  # the pair's longer read
    scan = [max(gap * 16 * (1 << q), -32768) for q in range(5)]
    lane = np.arange(32)[:, None]
    carry = np.zeros((segs, r, m), np.int64)
    found = []
    for base in range(0, int(span.max()), 512):
        cols = base + np.arange(512).reshape(32, 16)
        inside = cols[None] < span[:, None, None]
        tile = np.where(inside, ref[np.minimum(j0[:, None, None] + cols[None], n - 1)], REF_PAD).astype(np.int64)
        at = j0[:, None, None] + cols[None]  # the reference's columns
        own = inside & (at >= owned[:, 0, None, None]) & (at < owned[:, 1, None, None])
        h = np.zeros((segs, r, 32, 16), np.int64)
        above = np.zeros((segs, r), np.int64)
        for i in range(int(used.max(initial=0))):
            west = carry[:, :, i].copy() if base else np.zeros((segs, r), np.int64)
            nw = np.concatenate([_shift_lanes(h[..., -1:], 1, above[..., None, None]), h[..., :-1]], -1)
            v = (rd[None, :, i, None, None] == tile[:, None]) * (match - mismatch) + nw
            assert (v[:, 0::2] <= 0xFFFF).all()  # the low half carries nothing into the high one
            a = _addmax_relu(v, mismatch, h + gap)
            run = _addmax_relu(np.where(lane == 0, west[..., None, None], 0), gap, a[..., :1])
            for k in range(1, 16):
                run = _addmax_relu(run, gap, a[..., k : k + 1])
            for q in range(5):
                run = np.where(lane >= (1 << q), _addmax_relu(_shift_lanes(run, 1 << q, run), scan[q], run), run)
            h = a.copy()
            h[..., :1] = _addmax_relu(_shift_lanes(run, 1, west[..., None, None]), gap, a[..., :1])
            for k in range(1, 16):
                h[..., k : k + 1] = _addmax_relu(h[..., k - 1 : k], gap, a[..., k : k + 1])
            live = (i < used)[None, :] & (base < span)[:, None]
            hit = (h == best[None, :, None, None]) & (best > 0)[None, :, None, None] & own[:, None] \
                & live[..., None, None]
            if hit.any():
                for sg, rr, ln, k in zip(*np.nonzero(hit)):
                    found.append((rr, i, int(j0[sg] + cols[ln, k])))
            above = west
            carry[:, :, i] = np.where(live, h[..., -1, -1], carry[:, :, i])
    count = np.zeros(r, np.int64)
    cells = np.full((r, capacity, 2), -1, np.int64)
    for rr in range(r):
        mine = sorted((i, j) for q, i, j in found if q == rr)
        count[rr] = len(mine)
        if mine:
            cells[rr, : min(len(mine), capacity)] = mine[:capacity]
    return count, cells


@pytest.mark.parametrize("m", [1025, 1100])
def test_k8_wide_model_in_segments_matches_jax(m):
    """Tied reads of up to ``m`` positions (a read twice in the reference,
    a copy ending in the first columns a segment owns and one in the
    columns the segment before lists for it) against 4.5 kb cut into
    segments of whole tiles: the model's counts and cells equal the JAX
    package's ``_max_cells_device_batch``, at a capacity past every count
    and at one below some."""
    rng = np.random.default_rng(m)
    n = 4608
    plan = cuda_score.max_cells_segments(m, n, *PARAMS, 1, 2)
    stride, length, skip = plan
    assert skip == m + PARAMS[0] * m // -PARAMS[2] - 1 and length % 512 == 0 and stride < n
    owned = cuda_score.owned_columns(n, stride, skip)
    assert len([o for o in owned if o[1] > o[0]]) >= 3
    (ref,) = _seqs(rng, [n])
    tied = _seqs(rng, [m], np.array(list("ACG")))[0]
    ref = list(ref)
    for end in (owned[1][0], owned[1][0] - 1 + m + 40):  # the first column segment 1 owns, and later
        ref[end - m + 1 : end + 1] = tied
    ref = "".join(ref)
    reads = [tied, _mutated(rng, ref[1000 : 1000 + m - 7]), ref[3000 : 3000 + 60] * 2]
    reads_enc = jax_encode_batch(reads, m, JAX_READ_PAD)
    ref_enc = jax_encode_batch([ref], n, JAX_REF_PAD)[0]
    for capacity in (8, 1):
        best, count, cells = (np.asarray(x) for x in jax_longseq._max_cells_device_batch(
            reads_enc, ref_enc, *(np.int32(p) for p in PARAMS), capacity=capacity))
        assert count[0] == 2 and cells[0, 0, 1] == owned[1][0] and (best > 0).all()
        if capacity == 8:
            model = _cells_wide_model(encode_batch(reads, m, READ_PAD), encode_batch([ref], n, REF_PAD)[0],
                                      best, *PARAMS, 8, plan)
        got_count, got_cells = model[0], model[1][:, :capacity]
        np.testing.assert_array_equal(got_count, count)
        fits = count <= capacity
        np.testing.assert_array_equal(got_cells[fits], cells[fits])


def test_private_entries_refuse_the_16bit_form_outside_the_rules():
    """K3's private entry takes ``form="s16x2"`` at 4,096 lanes only with a
    longest read of at most 3,277 bp, and never past one pass with mismatch
    or gap 0 (the stripes); there it equals the plain version."""
    rng = np.random.default_rng(4)
    (ref,) = _seqs(rng, [40])
    packed, _ = pack_reads([ref[:30], ref[5:9]], 4096, row_multiple=2)
    flat, offs, seg_lens, ns = _segment([ref], 1, 0)
    args = (_t(packed), _t(flat), _t(offs), _t(seg_lens), _t(ns), _t(np.zeros((1,) + packed.shape, np.int32)))
    want = cuda_score.band_lane_best_plain(*args, *PARAMS)
    for got, w in zip(cuda_score._band_lane_best(*args, *PARAMS, longest=3277, form="s16x2"), want):
        np.testing.assert_array_equal(got, w)
    for longest, params in ((None, PARAMS), (3278, PARAMS), (30, (5, 0, -4)), (30, (5, -3, 0))):
        with pytest.raises(ValueError, match="cannot take form"):
            cuda_score._band_lane_best(*args, *params, longest=longest, form="s16x2")


def test_planners_cut_wide_rows_only_where_exact():
    """band_segments past one pass: W from the longest read given (else the
    row's width), stride >= 4 W, look-back W - 1; one piece under a
    positive mismatch or a zero gap.  max_cells_segments past one pass:
    whole tiles, skip W - 1, one segment where the signs do not bound a
    path.  A plan one column short of its look-back loses an alignment the
    model in pieces otherwise keeps."""
    cols = 1_000_000 + 15 * 8000
    for m, longest in ((2048, None), (2048, 2000), (4096, 3000)):
        stride, back = cuda_score.band_segments(m, cols, 16, 2, *PARAMS, 132, longest=longest)
        lanes = m if longest is None else longest
        w = lanes + 5 * lanes // 4
        assert back == w - 1 and stride >= 4 * w and len(cuda_score.band_pieces(1_000_000, stride, back)) > 10
    for params in ((5, 1, -4), (5, -3, 0), (0, -3, -4)):
        assert cuda_score.band_segments(2048, cols, 16, 2, *params, 132) == (cols, 0)
        assert cuda_score.max_cells_segments(2048, 131_072, *params, 1, 132) == (131_072, 131_072, 0)
    stride, length, skip = cuda_score.max_cells_segments(2048, 131_072, *PARAMS, 1, 132)
    assert skip == 2048 + 2560 - 1 and length % 512 == 0 and length >= stride + skip and stride < 131_072
    # An alignment with 39 reference gap columns (16 bp in two halves, 80 -
    # 39 = 41 beats either half's 40) ending on piece 1's first own column,
    # in rows of 1,025 lanes with reads of at most 16 bp (longest given).
    rng = np.random.default_rng(16)
    params = (5, -3, -1)
    split_read = _seqs(rng, [16], np.array(list("ACG")))[0]
    stride, back = cuda_score.band_segments(1025, 2000, 1, 1, *params, 8, longest=16)
    assert back == 16 + 80 - 1 and stride < 2000
    ref = list("T" * 2000)
    ref[stride + 1 - 55 : stride + 1] = split_read[:8] + "T" * 39 + split_read[8:]
    packed, start = pack_reads([split_read, split_read[:8]], 1025, row_multiple=2)
    flat, offs, seg_lens, ns = _segment(["".join(ref)], 1, 0)
    zero = np.zeros((1,) + packed.shape, np.int32)
    for look_back, want in ((back, 41), (53, 40)):
        lane, _, _ = _band_wide_model(packed, flat, offs, seg_lens, ns, zero, *params, plan=(stride, look_back))
        assert int(lane.reshape(-1)[start[0]]) == want
