"""K3's two forms and its column pieces: the rule that picks the 16-bit
form, a plain model of that form's arithmetic with the boundary columns,
and the plan that cuts a long segment into pieces over blocks.

``cuda_score.band_lane_best`` takes the s16x2 form (two packed rows per
warp in the 16-bit halves of each register) exactly when
``cuda_score.k3_form`` says every value fits int16 for every left column
within the contract 0 <= bnd <= match x m; the kernels run only on the
card (``chip_smoke.py`` [0], [5], [6]).  Here :func:`_band_s16x2_model`
computes what that kernel computes, in 16-bit values wrapped after every
add: the IMAD of the substitution, the left column taken into a lane's
state before its diagonal, the right column read off its diagonal.  It is
held to ``band_lane_best_plain`` at the rule's edge with the contract's
largest left column, and shown to wrap just past it.  The piece plan
(``cuda_score.band_segments``, ``band_pieces``) is held by running the
plain version on each piece (offset start, zero left column past piece 0)
and taking the max.  Tolerance 0 throughout: scores are integers.
"""

import inspect

import numpy as np
import pytest
import torch

from sparksmithwaterman_tpu.io.fasta import READ_PAD as JAX_READ_PAD
from sparksmithwaterman_tpu.io.fasta import REF_PAD as JAX_REF_PAD
from sparksmithwaterman_tpu.io.fasta import encode_batch as jax_encode_batch
from sparksmithwaterman_tpu.ops.recurrence import score_grid as jax_score_grid
from sparksmithwaterman_tpu_torch.io.fasta import encode_concat
from sparksmithwaterman_tpu_torch.ops import cuda_score
from sparksmithwaterman_tpu_torch.ops.packing import START_BIT, pack_reads

torch.set_num_threads(1)

PARAMS = (5, -3, -4)
_BASES = np.array(list("ACGT"))


def _seqs(rng, lens, bases=_BASES):
    return ["".join(rng.choice(bases, size=int(n))) for n in lens]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _args(packed, refs, ns, bnd):
    """band_lane_best's inputs for one segment of each of ``refs`` (one
    flat buffer read by offset)."""
    flat, lens = encode_concat(refs)
    offsets = np.concatenate(([0], np.cumsum(lens)[:-1])).astype(np.int64)
    return (_t(packed), _t(flat), _t(offsets), _t(lens.astype(np.int32)), _t(np.asarray(ns, np.int32)),
            _t(np.asarray(bnd, np.int32)))


def _starts(lane, packed):
    """lane (C, ROWS, M) at each read's START lane (lane 0 of a row too)."""
    start = torch.from_numpy((packed >= START_BIT) | (np.arange(packed.shape[1]) == 0))
    return lane[:, start]


def _wrap(x):
    """x as a 16-bit half of a register holds it (two's complement)."""
    return torch.remainder(x + 32768, 65536) - 32768


def _band_s16x2_model(packed, flat, offsets, seg_lens, ns, bnd, match, mismatch, gap, *, unroll=2):
    """(lane_best, bnd_out, carry_free) as K3's s16x2 form computes them:
    per anti-diagonal, lane i's state D_{d-1} (H) and NW term (U), every
    value a 16-bit half (int64 tensors wrapped after each add); before
    diagonal i lane i's H becomes bnd[i], which the lane below reads as
    its N term and keeps as its NW term (zero where it starts a read); on
    diagonal i + ns - 1 lane i's value leaves as bnd_out; the sweep runs
    m + ns - 1 diagonals rounded up to ``unroll``.  ``carry_free``: the
    IMAD's sum U + (match - mismatch), taken as an unsigned half, never
    passed 0xFFFF (no carry into the other row's half)."""
    rows, m = packed.shape
    lens = seg_lens.to(torch.int64).clamp_min(0)
    segs = cuda_score._padded_refs(flat, lens, offsets).to(torch.int64)
    width = ns.to(torch.int64).clamp_min(1)
    nd = -(-(m + width - 1) // unroll) * unroll
    read = (packed & (START_BIT - 1)).to(torch.int64)
    lane = torch.arange(m)
    keep = ~((packed >= START_BIT) | (lane == 0))
    shape = (ns.shape[0], rows, m)
    h_prev = torch.zeros(shape, dtype=torch.int64)
    u_nw = torch.zeros_like(h_prev)
    best = torch.zeros_like(h_prev)
    bnd_out = torch.zeros_like(h_prev)
    carry_free = True
    for d in range(int(nd.max())):
        if d < m:
            h_prev = torch.where(lane == d, bnd.to(torch.int64), h_prev)
        up = torch.nn.functional.pad(h_prev[..., :-1], (1, 0)) * keep
        col = cuda_score._ref_window(segs, lens, d, m).to(torch.int64)[:, None, :]
        v = (read[None] == col).to(torch.int64) * (match - mismatch) + torch.remainder(u_nw, 65536)
        carry_free &= int(v.max()) <= 0xFFFF
        h = torch.maximum(_wrap(v + mismatch), _wrap(torch.maximum(up, h_prev) + gap)).clamp_min(0)
        active = (d < nd)[:, None, None]
        best = torch.where(active, torch.maximum(best, h), best)
        bnd_out = torch.where((lane == d - (width[:, None] - 1))[:, None, :], h, bnd_out)
        u_nw, h_prev = up, torch.where(active, h, h_prev)
    start = torch.from_numpy((packed.numpy() >= START_BIT))
    return cuda_score.segmented_suffix_max(best, start), bnd_out, carry_free


def _by_pieces(args, params, stride, back):
    """band_lane_best_plain on every piece of every segment (the kernel's
    geometry, ``band_pieces``): piece k sweeps its columns from zero state
    (piece 0 from bnd); the lane bests maxed over pieces, bnd_out from the
    last piece."""
    packed, flat, offsets, seg_lens, ns, bnd = args
    lane, bout = torch.zeros_like(bnd), torch.zeros_like(bnd)
    for c in range(ns.shape[0]):
        pieces = cuda_score.band_pieces(int(ns[c]), stride, back)
        for k, (j0, j1) in enumerate(pieces):
            n = min(max(int(seg_lens[c]) - j0, 0), j1 - j0)
            l, b = cuda_score.band_lane_best_plain(
                packed, flat, offsets[c : c + 1] + j0, torch.tensor([n], dtype=torch.int32),
                torch.tensor([j1 - j0], dtype=torch.int32), bnd[c : c + 1] if k == 0 else torch.zeros_like(bnd[:1]),
                *params,
            )
            lane[c] = torch.maximum(lane[c], l[0])
            if k == len(pieces) - 1:
                bout[c] = b[0]
    return lane, bout


@pytest.mark.parametrize(
    "m, params, form",
    [
        (4, (4681, -3, -4), "s16x2"),  # 4,681 x (2 x 4 - 1) = 32,767 fits
        (4, (4682, -3, -4), "int32"),  # 32,774 does not
        (1024, (16, -3, -4), "s16x2"),  # 16 x 2,047 = 32,752
        (4096, (5, -3, -4), "int32"),  # wide rows: 5 x 8,191 > 32,767 by width alone
    ],
)
def test_k3_form_at_the_edges_of_its_rule(m, params, form):
    """The rule at K3's widths (k1_form's with 2m - 1 lanes: K1 at 4 lanes
    and match 4,682 is s16x2, K3 is not), and the private entry of the A/B
    refusing the s16x2 form exactly where the rule says int32."""
    assert cuda_score.k3_form(m, *params) == form
    assert cuda_score.k3_form(150, 5, -3, -32768) == "s16x2" and cuda_score.k3_form(150, 5, -3, -32769) == "int32"
    packed, _ = pack_reads(["ACGT", "GG"], m, row_multiple=4)
    args = _args(packed, ["ACGTTA"], [6], np.zeros((1,) + packed.shape, np.int32))
    want = cuda_score.band_lane_best_plain(*args, *params)
    for got, w in zip(cuda_score._band_lane_best(*args, *params, form="int32"), want):
        np.testing.assert_array_equal(got, w)
    if form == "s16x2":
        for got, w in zip(cuda_score._band_lane_best(*args, *params, form="s16x2", split=False), want):
            np.testing.assert_array_equal(got, w)
    else:
        with pytest.raises(ValueError):
            cuda_score._band_lane_best(*args, *params, form="s16x2")


@pytest.mark.parametrize("mismatch_gap", [(-3, -4), (-32768, -32768)])
def test_s16x2_model_at_the_rules_edge_with_the_largest_left_column(mismatch_gap):
    """Rows of 4 lanes, the left column at the contract's largest
    (match x 4) on every lane, a read whose lanes 1-3 equal the segment's
    columns 0-2 (so lane 3 reaches bnd + 3 match): at match 4,681 the 16-bit model equals the plain version (a cell
    reaches 32,767, and no IMAD carries); at 4,682, just outside the
    rule, the model wraps where the plain version reaches 32,774."""
    rng = np.random.default_rng(-sum(mismatch_gap))
    seg = "ACGTTGCA" + "".join(_seqs(rng, [20]))
    reads = ["TACG", "ACGT", "AC", "T", ""] + _seqs(rng, rng.integers(1, 5, 6))
    packed, _ = pack_reads(reads, 4, row_multiple=4)
    for match, fits in ((4681, True), (4682, False)):
        params = (match, *mismatch_gap)
        assert (cuda_score.k3_form(4, *params) == "s16x2") == fits
        bnd = np.full((2,) + packed.shape, match * 4, np.int32)
        args = _args(packed, [seg, seg[:5]], [len(seg), 9], bnd)
        want_lane, want_bout = cuda_score.band_lane_best_plain(*args, *params)
        lane, bout, carry_free = _band_s16x2_model(*args, *params)
        top = int(_starts(want_lane, packed).max())
        if fits:
            assert top == 32767 and carry_free
            np.testing.assert_array_equal(_starts(lane, packed), _starts(want_lane, packed))
            np.testing.assert_array_equal(bout, want_bout)
        else:
            assert top == 32774
            assert int(_starts(lane, packed).max()) != top


@pytest.mark.parametrize("m_pack, unroll", [(32, 2), (96, 6)])
def test_s16x2_model_matches_plain_and_jax_on_random_segments(m_pack, unroll):
    """Random reads and segments (all pad past their bytes, of one column,
    empty), random left columns within the contract, the kernel's unroll
    at L = 1 and 3: the model equals the plain version at every start lane
    and bnd_out lane; chained over three segments from a zero column it
    equals the JAX recurrence on the whole reference."""
    rng = np.random.default_rng(m_pack)
    reads = _seqs(rng, rng.integers(1, m_pack + 1, 9)) + [""]
    packed, _ = pack_reads(reads, m_pack, row_multiple=4)
    refs = _seqs(rng, [70, 23, 0, 1])
    ns = [70, 40, 1, 5]
    bnd = rng.integers(0, 5 * m_pack + 1, size=(len(refs),) + packed.shape).astype(np.int32)
    args = _args(packed, refs, ns, bnd)
    want_lane, want_bout = cuda_score.band_lane_best_plain(*args, *PARAMS)
    lane, bout, carry_free = _band_s16x2_model(*args, *PARAMS, unroll=unroll)
    assert carry_free
    np.testing.assert_array_equal(_starts(lane, packed), _starts(want_lane, packed))
    np.testing.assert_array_equal(bout, want_bout)
    ref = "".join(_seqs(rng, [150]))
    flat, _ = encode_concat([ref])
    got, left = None, torch.zeros((1,) + packed.shape, dtype=torch.int32)
    for s in range(3):
        seg_args = (_t(packed), _t(flat), torch.tensor([50 * s]), torch.tensor([50], dtype=torch.int32),
                    torch.tensor([50], dtype=torch.int32), left)
        seg_lane, left, _ = _band_s16x2_model(*seg_args, *PARAMS, unroll=unroll)
        left = left.to(torch.int32)
        got = _starts(seg_lane, packed) if got is None else torch.maximum(got, _starts(seg_lane, packed))
    _, start = pack_reads(reads, m_pack, row_multiple=4)
    want = np.asarray(jax_score_grid(jax_encode_batch(reads, m_pack, JAX_READ_PAD),
                                     jax_encode_batch([ref], 150, JAX_REF_PAD), *(np.int32(p) for p in PARAMS)))[:, 0]
    flat_lane = torch.zeros(packed.size, dtype=torch.int64)
    start_mask = ((packed >= START_BIT) | (np.arange(m_pack) == 0)).reshape(-1)
    flat_lane[torch.from_numpy(start_mask)] = got[0]
    np.testing.assert_array_equal(flat_lane[start].numpy(), want)


def test_pieces_hold_an_alignment_across_a_border_and_a_real_left_column():
    """A segment after a real first segment (its left column is that
    segment's right one, carrying a read planted across the segment edge)
    cut into the planned pieces: an optimal alignment with 39 reference gap
    columns (a 16 bp read of A, C and G in two halves in a ref of Ts; 80 -
    39 = 41 beats either half's 40) ends on piece 1's first own column and
    starts 54 columns before it, so only piece 1's look-back of W - 1 holds
    it.  The pieces
    equal the unsplit segment at every start lane and bnd_out lane, and the
    two segments chained equal the JAX recurrence on the whole reference;
    one column less of look-back loses the planted alignment."""
    rng = np.random.default_rng(8)
    params = (5, -3, -1)
    m = 16
    edge_read, split_read = (_seqs(rng, [16], np.array(list("ACG")))[0] for _ in range(2))
    n0, n1 = 600, 2000
    stride, back = cuda_score.band_segments(m, n1, 1, 1, *params, sms=8)
    w = m + params[0] * m // -params[2]
    assert back == w - 1 and 4 * w <= stride < n1
    span = 16 + 39
    ref = list("T" * (n0 + n1))
    ref[n0 - 8 : n0 + 8] = edge_read
    ref[n0 + stride + 1 - span : n0 + stride + 1] = split_read[:8] + "T" * 39 + split_read[8:]
    ref = "".join(ref)
    reads = [split_read, edge_read, split_read[:8]]
    packed, start = pack_reads(reads, m, row_multiple=4)
    flat, _ = encode_concat([ref])
    zero = torch.zeros((1,) + packed.shape, dtype=torch.int32)
    seg0 = (_t(packed), _t(flat), torch.tensor([0]), torch.tensor([n0], dtype=torch.int32),
            torch.tensor([n0], dtype=torch.int32), zero)
    lane0, left = cuda_score.band_lane_best_plain(*seg0, *params)
    assert int(left.max()) > 0  # the edge read enters segment 1 through its left column
    seg1 = (_t(packed), _t(flat), torch.tensor([n0]), torch.tensor([n1], dtype=torch.int32),
            torch.tensor([n1], dtype=torch.int32), left)
    want_lane, want_bout = cuda_score.band_lane_best_plain(*seg1, *params)
    lane, bout = _by_pieces(seg1, params, stride, back)
    np.testing.assert_array_equal(_starts(lane, packed), _starts(want_lane, packed))
    np.testing.assert_array_equal(bout, want_bout)
    got = torch.maximum(lane0, lane).reshape(-1)[start]
    want = np.asarray(jax_score_grid(jax_encode_batch(reads, m, JAX_READ_PAD),
                                     jax_encode_batch([ref], n0 + n1, JAX_REF_PAD), *(np.int32(p) for p in params)))
    np.testing.assert_array_equal(got.numpy(), want[:, 0])
    assert want[:, 0].tolist() == [41, 80, 40]
    short, _ = _by_pieces(seg1, params, stride, span - 2)
    assert int(short.reshape(-1)[start[0]]) == 40


def test_pieces_of_short_empty_and_mixed_length_refs():
    """Segments of 0, 1, 50 and 300 columns beside one far longer (6,000,
    120 times the next): the plan cuts the long one into many pieces and
    the 300-column one into two, leaves the short ones whole, and puts
    more blocks on the card than its target; no piece sweeps more than
    the plan's stride plus its look-back.  The pieces equal the unsplit
    segments at every start lane and bnd_out lane, left columns random
    within the contract."""
    rng = np.random.default_rng(9)
    reads = _seqs(rng, rng.integers(1, 21, 6)) + [""]
    packed, _ = pack_reads(reads, 20, row_multiple=4)
    refs = _seqs(rng, [0, 1, 50, 300, 6000])
    ns = np.maximum(1, [len(r) for r in refs])
    bnd = rng.integers(0, 5 * 20 + 1, size=(len(refs),) + packed.shape).astype(np.int32)
    args = _args(packed, refs, ns, bnd)
    row_blocks, sms = 1, 4
    stride, back = cuda_score.band_segments(20, int(ns.sum()), len(refs), row_blocks, *PARAMS, sms)
    counts = [len(cuda_score.band_pieces(n, stride, back)) for n in ns]
    widths = [j1 - j0 for n in ns for j0, j1 in cuda_score.band_pieces(n, stride, back)]
    assert counts[:3] == [1, 1, 1] and counts[3] == 2 and counts[4] > 30
    assert sum(counts) * row_blocks >= cuda_score._K3_BLOCKS_PER_SM * sms
    assert max(widths) <= stride + back
    want_lane, want_bout = cuda_score.band_lane_best_plain(*args, *PARAMS)
    lane, bout = _by_pieces(args, PARAMS, stride, back)
    np.testing.assert_array_equal(_starts(lane, packed), _starts(want_lane, packed))
    np.testing.assert_array_equal(bout, want_bout)


def test_pieces_fall_back_to_one_where_the_plan_cannot_split():
    """One piece a segment, (cols, 0), wherever the bound does not hold or
    a cut buys nothing: a positive mismatch, a zero gap, a zero match,
    rows wider than one pass whose segments are shorter than 4 W in all,
    a launch whose rows alone fill the card, segments shorter than 4 W in
    all, and empty shapes; at the card's
    scale, a 1 Mb segment among 8 kb ones is cut and the 8 kb ones are
    not."""
    cols = 1_000_000 + 63 * 8000
    stride, back = cuda_score.band_segments(256, cols, 64, 16, *PARAMS, 132)
    assert 8000 < stride < 1_000_000 and back == 256 + 5 * 256 // 4 - 1
    assert len(cuda_score.band_pieces(1_000_000, stride, back)) > 10
    assert cuda_score.band_pieces(8000, stride, back) == [(0, 8000)]
    assert cuda_score.band_pieces(0, stride, back) == [(0, 1)]
    for m, params, refs, row_blocks, width in (
        (256, (5, 1, -4), 1, 4, cols),
        (256, (5, -3, 0), 1, 4, cols),
        (256, (0, -3, -4), 1, 4, cols),
        (1025, PARAMS, 1, 4, 4 * (1025 + 5 * 1025 // 4)),
        (256, PARAMS, 1, cuda_score._K3_BLOCKS_PER_SM * 132, cols),
        (256, PARAMS, 2, 4, 4 * (256 + 5 * 256 // 4)),
        (0, PARAMS, 1, 4, cols),
        (256, PARAMS, 1, 4, 0),
        (256, PARAMS, 0, 4, cols),
    ):
        assert cuda_score.band_segments(m, width, refs, row_blocks, *params, 132) == (width, 0), (m, params, width)


def test_no_public_function_takes_a_form():
    """K3's form and its pieces follow from the data alone:
    ``band_lane_best`` keeps its signature, and ``K3_FORMS`` counts both
    forms; a form K3 lacks raises."""
    for name, fn in inspect.getmembers(cuda_score, inspect.isfunction):
        if fn.__module__ == cuda_score.__name__ and not name.startswith("_"):
            assert "form" not in inspect.signature(fn).parameters, name
    assert list(inspect.signature(cuda_score.band_lane_best).parameters) == [
        "packed", "seg_u8", "offsets", "seg_lens", "ns", "bnd", "match", "mismatch", "gap", "carry_cols", "longest",
    ]
    cuda_score.reset_launches()
    assert cuda_score.K3_FORMS == {"s16x2": 0, "int32": 0}
    packed, _ = pack_reads(["ACGT"], 128)
    with pytest.raises(ValueError):
        cuda_score._band_lane_best(*_args(packed, ["ACGT"], [4], np.zeros((1,) + packed.shape)), *PARAMS,
                                   form="int8")
