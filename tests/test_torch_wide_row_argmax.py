"""K5's and K2's 16-bit forms for reads wider than one pass, on the CPU.

Past ONE_PASS_LANES positions ``cuda_score.score_grid_row`` (K5) takes the
s16x2 form where ``cuda_score.k5_form`` says so (the row form has no
stripes, so the one-pass rule holds at any width), and
``cuda_score.argmax_lane`` (K2) where ``cuda_score.k1k4_form`` does (its
rows run in stripes).  The kernels run only on the card (``chip_smoke.py``
[0], [14]).  Here :func:`_k5_wide_model` computes what
``score_row_wide_s16x2_kernel`` computes, a pair of reads in the two 16-bit
halves of each 32-bit word (the IMAD of the substitution on the whole word,
so a carry between halves would show), tiles of 512 columns and the
carried column one word a row, and is held to the JAX row recurrence
(``sparksmithwaterman_tpu.ops.recurrence.score_grid``).
:func:`_k2_wide_model` computes what ``argmax_wide_s16x2_kernel`` computes:
stripes of lanes, each run only as far as a cell can be non-zero, its carry
row cut where the kernel cuts it, the stripes past the pad rows' stop not
run at all, the argmax state in 16-bit halves with its epochs; it is held
to ``argmax_lane_plain`` on every lane and to the JAX package's
``pallas_argmax_grid_diag_chunked`` (interpret mode) on the lanes the
traceback reads.  Tolerance 0 throughout: scores, diagonals and counts are
integers.
"""

import inspect

import numpy as np
import pytest
import torch

from sparksmithwaterman_tpu.ops.pallas_score import pallas_argmax_grid_diag_chunked
from sparksmithwaterman_tpu.ops.recurrence import score_grid as jax_score_grid
from sparksmithwaterman_tpu_torch.io.fasta import READ_PAD, REF_PAD, encode_batch
from sparksmithwaterman_tpu_torch.ops import cuda_score

torch.set_num_threads(1)

PARAMS = (5, -3, -4)
_BASES = np.array(list("ACGT"))


def _seqs(rng, lens):
    return ["".join(rng.choice(_BASES, size=int(n))) for n in lens]


def _mutated(rng, seq, rate=1 / 30):
    """seq with about one base in 1 / rate changed, so that it scores high
    against where it came from."""
    arr = np.array(list(seq))
    hit = rng.random(arr.size) < rate
    arr[hit] = rng.choice(_BASES, size=int(hit.sum()))
    return "".join(arr)


def _grid(reads, refs, m):
    n = max(1, max(map(len, refs)))
    return torch.from_numpy(encode_batch(reads, m, READ_PAD)), torch.from_numpy(encode_batch(refs, n, REF_PAD))


# -- 16-bit halves of a 32-bit word, as the DPX and SIMD intrinsics see them ---


def _s16(x):
    return (np.asarray(x, np.int64) + 32768) % 65536 - 32768


def _lo_hi(w):
    w = np.asarray(w, np.int64)
    return _s16(w & 0xFFFF), _s16(w >> 16)


def _word(lo, hi):
    return (np.asarray(lo, np.int64) & 0xFFFF) | ((np.asarray(hi, np.int64) & 0xFFFF) << 16)


def _pair16(v):
    return _word(v, v)


def _vadd2(a, b):
    (al, ah), (bl, bh) = _lo_hi(a), _lo_hi(b)
    return _word(al + bl, ah + bh)


def _addmax_relu(a, b, c):
    """__viaddmax_s16x2_relu: per half max(a + b wrapped, c, 0)."""
    (al, ah), (bl, bh), (cl, ch) = _lo_hi(a), _lo_hi(b), _lo_hi(c)
    return _word(np.maximum(np.maximum(_s16(al + bl), cl), 0), np.maximum(np.maximum(_s16(ah + bh), ch), 0))


def _vmax2(a, b):
    (al, ah), (bl, bh) = _lo_hi(a), _lo_hi(b)
    return _word(np.maximum(al, bl), np.maximum(ah, bh))


def _shift_lanes(x, s, fill):
    """__shfl_up_sync by s over the lane axis (-2): lanes below s get fill."""
    out = np.roll(x, s, axis=-2)
    out[..., :s, :] = fill[..., :s, :] if np.ndim(fill) else fill
    return out


def _k5_wide_model(reads_t, refs_t, match, mismatch, gap):
    """(R, C) bests as score_row_wide_s16x2_kernel computes them: reads 2p
    and 2p + 1 in the low and high halves of each word, every row of a
    512-column tile (32 lanes x 16 columns) before the next, up to the
    pair's longer read and the reference's last non-pad column; the
    substitution eq x (match - mismatch) + NW as one 32-bit multiply-add
    (no half may carry into the other), the recurrence and the decaying
    scan in DPX steps, the scan's steps across lanes gap x 16 x 2^q clamped
    at -32,768, the carried column one word a row."""
    r, m = reads_t.shape
    c, n = refs_t.shape
    reads = np.concatenate([reads_t.numpy().astype(np.int64), np.full((r % 2, m), READ_PAD)])
    refs = refs_t.numpy().astype(np.int64)
    lo_rd, hi_rd = reads[0::2], reads[1::2]
    pairs = lo_rd.shape[0]
    used = np.array([1 + max([i for i in range(m) if lo_rd[p, i] != READ_PAD or hi_rd[p, i] != READ_PAD],
                             default=-1) for p in range(pairs)])
    lens = np.array([1 + max([j for j in range(n) if refs[k, j] != REF_PAD], default=-1) for k in range(c)])
    k_sub, mismatch2, gap2 = match - mismatch, _pair16(mismatch), _pair16(gap)
    scan = [_pair16(max(gap * 16 * (1 << q), -32768)) for q in range(5)]
    lane = np.arange(32)[:, None]
    best = np.zeros((pairs, c), np.int64)
    carry = np.zeros((pairs, c, m), np.int64)
    for base in range(0, int(lens.max(initial=0)), 512):
        cols = base + np.arange(512).reshape(32, 16)
        ref_tile = np.where(cols[None] < lens[:, None, None], refs[:, np.minimum(cols, n - 1)], REF_PAD)
        h = np.zeros((pairs, c, 32, 16), np.int64)
        above = np.zeros((pairs, c), np.int64)
        for i in range(int(used.max(initial=0))):
            west = carry[:, :, i].copy() if base else np.zeros((pairs, c), np.int64)
            nw = np.concatenate([_shift_lanes(h[..., -1:], 1, above[..., None, None]), h[..., :-1]], -1)
            eq = _word(lo_rd[:, i, None, None, None] == ref_tile[None], hi_rd[:, i, None, None, None] == ref_tile[None])
            v = (eq * k_sub + nw) % (1 << 32)
            assert (v >> 16 == (eq >> 16) * k_sub + (nw >> 16)).all()  # no carry between the halves
            a = _addmax_relu(v, mismatch2, _vadd2(h, gap2))
            run = _addmax_relu(np.where(lane == 0, west[..., None, None], 0), gap2, a[..., :1])
            for k in range(1, 16):
                run = _addmax_relu(run, gap2, a[..., k : k + 1])
            for q in range(5):
                run = np.where(lane >= (1 << q), _addmax_relu(_shift_lanes(run, 1 << q, run), scan[q], run), run)
            h = a.copy()
            h[..., :1] = _addmax_relu(_shift_lanes(run, 1, west[..., None, None]), gap2, a[..., :1])
            for k in range(1, 16):
                h[..., k : k + 1] = _addmax_relu(h[..., k - 1 : k], gap2, a[..., k : k + 1])
            live = (i < used)[:, None] & (base < lens)[None, :]
            best = np.where(live, _vmax2(best, _tile_max(h)), best)
            above = west
            carry[:, :, i] = np.where(live, h[..., -1, -1], carry[:, :, i])
    lo, hi = _lo_hi(best)
    return np.stack([lo, hi], 1).reshape(-1, c)[:r]


def _tile_max(h):
    """The per-half max over a tile's lanes and columns (the kernel's
    __vimax3_s16x2 over a row, then the warp's reductions)."""
    lo, hi = _lo_hi(h)
    return _word(lo.max(axis=(-1, -2)), hi.max(axis=(-1, -2)))


def _k2_stripe_plan(m, n, params, used, stripe, j0, length, lo, hi):
    """The stripes a pair runs and each stripe's diagonals and carry
    columns, as argmax_wide_s16x2_kernel plans them."""
    match, mismatch, gap = params
    p = min(-mismatch, -gap)
    cols = min(length, n) + m  # the kernel's carry row
    length = min(length, n - j0)
    stop = 0 if used == 0 else min(m, used - 1 + -(-match * min(used, length) // p))

    def diagonals(t):
        i0 = t * stripe
        lanes = min(stripe, m - i0)
        return min(hi - i0, lanes + length + -(-match * min(i0 + lanes, used, length) // p) - 1)

    return -(-stop // stripe), diagonals, (lambda t: max(0, min(cols, diagonals(t) - stripe + 1))), length


def _k2_wide_model(reads_t, refs_t, params, *, stripe=8, epoch=24, plan=None, extra=11):
    """(best, bestd, count), (S, R, C, M) partials of each column segment
    of ``plan`` (one segment by default), as argmax_wide_s16x2_kernel
    computes them with stripes of ``stripe`` lanes: per pair of reads
    (their longer read u), the stripes below lane u - 1 + ceil(match u /
    p) only, each a DP over its lanes from the carry row of the stripe
    above (0 past the columns that stripe wrote) and H = 0 at the
    segment's left edge, run ``extra`` diagonals past what the kernel
    needs (the rounding and the pipeline's longest stripe), values in
    16-bit halves; per lane the kernel's 16-bit argmax state over the
    diagonals the segment owns, on the pipeline's clock (stripe t starts
    (t mod 4) x (``stripe`` + 64) diagonals late, its cells 0 until then)
    and flushed every ``epoch`` diagonals of it."""
    match, mismatch, gap = params
    r, m = reads_t.shape
    c, n = refs_t.shape
    stride, length, offset, count = plan or (n, n, 0, 1)
    reads = reads_t.numpy().astype(np.int64)
    refs = refs_t.numpy().astype(np.int64)
    out = np.zeros((3, count, r, c, m), np.int64)
    for seg in range(count):
        j0 = seg * stride
        lo = 0 if seg == 0 else offset
        hi = m + n - 1 - j0 if seg == count - 1 else stride + offset
        for ci in range(c):
            for p0 in range(0, r, 2):
                pair = reads[p0 : p0 + 2]
                used = 1 + max([i for i in range(m) if (pair[:, i] != READ_PAD).any()], default=-1)
                stripes, diagonals, carried, seg_len = _k2_stripe_plan(m, n, params, used, stripe, j0, length, lo, hi)
                carry = np.zeros((len(pair), 0), np.int64)
                for t in range(stripes):
                    i0, nd = t * stripe, diagonals(t)
                    lanes = min(stripe, m - i0)
                    # The kernel's warp t % 4 runs the sweep's diagonal g
                    # as the stripe's g - lag, its epochs on the sweep's.
                    lag = t % 4 * (stripe + 64)
                    cols = nd + extra
                    h = np.zeros((len(pair), lanes + 1, cols + 1), np.int64)  # row 0: the carry, column 0: the edge
                    h[:, 0, 1 : carry.shape[1] + 1] = carry[:, :cols]
                    state = np.zeros((3, len(pair), lanes), np.int64)  # 16-bit best, bestd, count
                    merged = np.stack([np.full((len(pair), lanes), -1), np.zeros((len(pair), lanes), np.int64),
                                       np.zeros((len(pair), lanes), np.int64)])
                    ebase = 0
                    for g in range(lag + nd + extra):
                        if g - ebase == epoch:
                            _flush16(state, merged, ebase - lag + i0 + j0)
                            ebase = g
                        d = g - lag
                        for il in range(lanes):
                            j = d - il
                            cell = np.zeros(len(pair), np.int64)  # left of the segment: 0
                            if j >= 0:
                                col = refs[ci, j0 + j] if j < seg_len else REF_PAD
                                sub = np.where(pair[:, i0 + il] == col, match, mismatch)
                                cell = np.maximum(np.maximum(_s16(h[:, il, j] + sub),
                                                             _s16(np.maximum(h[:, il, j + 1], h[:, il + 1, j]) + gap)), 0)
                                h[:, il + 1, j + 1] = cell
                            owned = lo <= d + i0 < hi
                            _update16(state, il, cell if owned else np.zeros_like(cell), g - ebase)
                    _flush16(state, merged, ebase - lag + i0 + j0)
                    out[:, seg, p0 : p0 + 2, ci, i0 : i0 + lanes] = merged
                    carry = h[:, lanes, 1 : 1 + carried(t)] if lanes == stripe else carry[:, :0]
    parts = tuple(torch.from_numpy(x.astype(np.int32)) for x in out)
    return parts if count > 1 else tuple(x[0] for x in parts)


def _update16(state, il, h, d):
    """One cell of each half into K2's 16-bit state (argmax_update16)."""
    best, bestd, count = state[:, :, il]
    t = _s16(h - best)
    gt = np.clip(t, 0, 1)
    ge = np.clip(_s16(t + 1), 0, 1)
    state[0, :, il] = np.maximum(best, h)
    state[2, :, il] = np.maximum(_s16(count + _s16(gt * 0x8001 + ge)), gt)
    state[1, :, il] = np.maximum(_s16(_s16(d + 32769) + gt * 0x7FFF), bestd)


def _flush16(state, merged, dbase):
    """The kernel's flush: the state into (best, bestd, count), then 0."""
    b, bd, cnt = state
    cnt, bd = np.where(b > 0, cnt, 0), np.where(b > 0, bd + dbase, 0)
    gt, eq = b > merged[0], (b == merged[0]) & (b > 0)
    merged[1] = np.where(gt, bd, merged[1])
    merged[2] = np.where(gt, cnt, merged[2] + np.where(eq, cnt, 0))
    merged[0] = np.maximum(merged[0], b)
    state[:] = 0


# -- the rules --------------------------------------------------------------------


def test_k5_and_k2_forms_at_the_edges_of_their_rules():
    """k5_form: k1_form's up to 1,024 positions, then s16x2 wherever
    match x m <= 32,767 and -32,768 <= mismatch, gap <= 0 <= match (6,553
    bp under the default scheme; a zero mismatch too: no stripes); K2's
    k1k4_form: the same bound past 1,024 but mismatch < 0 and gap < 0."""
    for m, params, k5, k2 in (
        (1024, PARAMS, "s16x2", "s16x2"),
        (1025, PARAMS, "s16x2", "s16x2"),
        (6553, PARAMS, "s16x2", "s16x2"),
        (6554, PARAMS, "int32", "int32"),
        (1057, (31, -3, -4), "s16x2", "s16x2"),  # 31 x 1,057 = 32,767
        (1057, (32, -3, -4), "int32", "int32"),
        (2048, (5, 0, -4), "s16x2", "int32"),
        (2048, (5, -3, 0), "s16x2", "int32"),
        (2048, (5, -32768, -32768), "s16x2", "s16x2"),
        (2048, (5, -32769, -4), "int32", "int32"),
        (100, (5, 1, -4), "int32", "int32"),
    ):
        assert cuda_score.k5_form(m, *params) == k5, (m, params)
        assert cuda_score.k1k4_form(m, *params) == k2, (m, params)
        if m <= cuda_score.ONE_PASS_LANES:
            assert cuda_score.k5_form(m, *params) == cuda_score.k1_form(m, *params)


def test_private_entries_refuse_s16x2_outside_the_rules():
    """_score_grid_row and _argmax_lane take "s16x2" only where k5_form and
    k1k4_form give it (on the CPU they then run the plain versions and
    launch nothing); the public wrappers take no form, and the pair form's
    carry is half the int32 form's."""
    for m, params in ((6554, PARAMS), (1100, (30, -3, -4))):
        reads_t, refs_t = _grid(["ACGT"], ["ACGTT"], m)
        with pytest.raises(ValueError, match="K5 cannot take form 's16x2'"):
            cuda_score._score_grid_row(reads_t, refs_t, *params, form="s16x2")
        with pytest.raises(ValueError, match="K2 cannot take form 's16x2'"):
            cuda_score._argmax_lane(reads_t, refs_t, *params, form="s16x2")
    reads_t, refs_t = _grid(["ACGT"], ["ACGTT"], 1100)
    with pytest.raises(ValueError, match="K2 cannot take form 's16x2'"):
        cuda_score._argmax_lane(reads_t, refs_t, 5, 0, -4, form="s16x2")
    cuda_score.reset_launches()
    want = cuda_score.score_grid_row(reads_t, refs_t, 5, 0, -4)
    assert torch.equal(cuda_score._score_grid_row(reads_t, refs_t, 5, 0, -4, form="s16x2"), want)
    assert cuda_score.LAUNCHES["score_grid_row"] == 0 and cuda_score.K5_FORMS == {"s16x2": 0, "int32": 0}
    for fn in (cuda_score.score_grid_row, cuda_score.argmax_lane):
        assert list(inspect.signature(fn).parameters) == ["reads_u8", "refs_u8", "match", "mismatch", "gap"]
    int32 = cuda_score.carry_elems(4096, 13, 0, row_form=True)
    assert int32 == 16 * 4096 and cuda_score.carry_elems(4096, 13, 0, row_form=True, pair=True) == int32 // 2
    assert cuda_score.carry_elems(1024, 13, 0, row_form=True, pair=True) == 0


# -- K5: the wide row scan in 16-bit halves -------------------------------------------


@pytest.mark.parametrize("case", ["1,025-2,048", "the rule's edge", "gap -1"])
def test_k5_wide_model_equals_the_jax_row_recurrence(case):
    """The 16-bit model of K5's wide kernel against the JAX package's row
    recurrence: reads of 1-2,048 bp (an odd count, an empty read) across
    tiles of 512 columns; a 1,057 bp read equal to its reference at match
    31 (31 x 1,057 = 32,767, the largest score the rule admits); and gap
    -1, whose long gap chains cross lanes and tiles."""
    rng = np.random.default_rng({"1,025-2,048": 41, "the rule's edge": 42, "gap -1": 43}[case])
    if case == "1,025-2,048":
        params, m = PARAMS, 2048
        ref = "".join(_seqs(rng, [900]))
        reads = [_mutated(rng, ref + ref[:1148]), _mutated(rng, ref[40:] + ref[:200]), "", ref[500:501]]
        reads += _seqs(rng, [700]) + [_mutated(rng, ref[::-1] + ref[:125])]
        refs = [ref, "".join(_seqs(rng, [600])), "A"]
    elif case == "the rule's edge":
        params, m = (31, -3, -4), 1057
        ref = "".join(_seqs(rng, [1200]))
        reads = [ref[100:1157], _mutated(rng, ref[100:1157]), ref[:20]]
        refs = [ref, "".join(_seqs(rng, [530]))]
    else:
        params, m = (5, -3, -1), 1100
        ref = "".join(_seqs(rng, [1300]))
        reads = [ref[:300] + "".join(_seqs(rng, [500])) + ref[900:1200], _mutated(rng, ref[200:1300], 1 / 5)]
        refs = [ref, ref[::-1]]
    assert cuda_score.k5_form(m, *params) == "s16x2"
    reads_t, refs_t = _grid(reads, refs, m)
    want = np.asarray(jax_score_grid(reads_t.numpy(), refs_t.numpy(), *params))
    np.testing.assert_array_equal(_k5_wide_model(reads_t, refs_t, *params), want)
    np.testing.assert_array_equal(cuda_score.score_grid_row(reads_t, refs_t, *params).numpy(), want)
    if case == "the rule's edge":
        assert want[0, 0] == 32767


# -- K2: the striped argmax in 16-bit halves -------------------------------------------


@pytest.mark.parametrize("case", ["pad rows stop", "pad columns", "segments"])
def test_k2_wide_model_equals_plain_on_every_lane(case):
    """The model of K2's wide kernel in stripes of 8 lanes against
    argmax_lane_plain on every lane: short reads padded to a long width,
    so that their stripes past the pad rows' stop are not run; reads
    longer than the reference, whose best lies in the columns right of it
    (a cell past the reference's end can exceed every real cell of its
    row, and the stripes must run that far); and the reference cut into
    column segments, merged."""
    rng = np.random.default_rng({"pad rows stop": 51, "pad columns": 52, "segments": 53}[case])
    plan = None
    if case == "pad rows stop":
        ref = "".join(_seqs(rng, [30]))
        reads = [_mutated(rng, ref[3:9], 0)] + _seqs(rng, [4, 7, 0, 1]) + [ref[10:13]]
        m, refs = 48, [ref, "".join(_seqs(rng, [17]))]
    elif case == "pad columns":
        ref = "".join(_seqs(rng, [12]))
        reads = [ref + "CCCCCCCC" + "".join(_seqs(rng, [10])), "".join(_seqs(rng, [26])), ref[4:] + "GGGG"]
        m, refs = 30, [ref]
    else:
        ref = "".join(_seqs(rng, [150]))
        reads = [_mutated(rng, ref[20:32], 0), _mutated(rng, ref[100:112]), "".join(_seqs(rng, [9]))]
        m, refs = 12, [ref]
        offset = m + PARAMS[0] * m // -PARAMS[2] + m - 2
        plan = (25, 25 + offset, offset, -(-(m + 150 - 1 - offset) // 25))
    reads_t, refs_t = _grid(reads, refs, m)
    want = cuda_score.argmax_lane_plain(reads_t, refs_t, *PARAMS)
    got = _k2_wide_model(reads_t, refs_t, PARAMS, plan=plan)
    if plan is not None:
        got = cuda_score.argmax_merge_plain(*got)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    if case == "pad rows stop":
        used = max(map(len, reads[:2]))
        stripes, _, _, _ = _k2_stripe_plan(m, 30, PARAMS, used, 8, 0, 30, 0, m + 29)
        assert stripes * 8 < m and not want[0][:2, :, stripes * 8 :].any()
    if case == "pad columns":
        real = want[0][0, 0, 12:] > 0
        assert (want[1][0, 0, 12:][real] - torch.arange(12, m)[real] >= 12).any()  # a row's best right of the ref


def test_k2_wide_model_matches_pallas_interpret():
    """The model, with small epochs, against the JAX package's TPU kernel
    (interpret mode) on the lanes the traceback reads: reads across
    several stripes and one short read padded past its stop."""
    rng = np.random.default_rng(54)
    ref = "".join(_seqs(rng, [40]))
    reads = [_mutated(rng, ref[5:29]), "".join(_seqs(rng, [21])), ref[30:34], _mutated(rng, ref[::-1][:17])]
    reads += _seqs(rng, [24, 3, 9, 0])
    reads_t, refs_t = _grid(reads, [ref], 24)
    want = tuple(torch.from_numpy(np.array(t)) for t in pallas_argmax_grid_diag_chunked(
        reads_t.numpy(), refs_t.numpy(), *PARAMS, read_block=8, chunk=64, unroll=4, interpret=True))
    got = _k2_wide_model(reads_t, refs_t, PARAMS, stripe=8, epoch=7)
    cons = want[0] == want[0].amax(dim=2, keepdim=True)
    assert torch.equal(got[0] == got[0].amax(dim=2, keepdim=True), cons)
    for g, w in zip(got, want):
        assert torch.equal(g[cons], w[cons])
