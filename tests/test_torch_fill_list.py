"""The traceback's fill, listing and walk in one launch (``fill_list``,
``fill_walk``, ``csrc/fill_walk.cu``) on the CPU.

The wrappers take their plain versions for CPU tensors (the kernel runs
only on the card, where ``chip_smoke.py`` [2] holds it to them).  Here the
port's ``device_traceback.fill_and_trace`` and ``longseq._fill_walk_known``
are held to the JAX package's on the same encoded inputs, in both tie
orders; a model of the kernel's block (its lock-step schedule of warps over
tiles, the columns handed between warps through a double buffer and
between rounds through a column, each tile's running best and list, their
merge by a row-major sort, the walk over 2-bit codes) to the plain
versions at tile widths and warp counts that cut ties and rounds; and
``fill_plan`` at the shapes of the main path.  Tolerance 0 throughout:
scores, cells and codes are integers.
"""

import numpy as np
import pytest
import torch

from sparksmithwaterman_tpu.ops import device_traceback as jax_dt
from sparksmithwaterman_tpu.ops import longseq as jax_longseq
from sparksmithwaterman_tpu_torch.io.fasta import READ_PAD, REF_PAD, encode_batch
from sparksmithwaterman_tpu_torch.ops import cuda_score, device_traceback, longseq

torch.set_num_threads(1)

PARAMS = (5, -3, -4)
_BASES = np.array(list("ACGT"))
TIES = ("serial", "distributed")


def _seqs(rng, lens):
    return ["".join(rng.choice(_BASES, size=int(n))) for n in lens]


def _tied_pairs():
    """Reads against one 600-column reference: a 12-mer copied to end at
    column 127 (the last of a 128-column tile), across the border at 128
    and inside the third tile, so its three max cells lie in three tiles;
    "CA" against 70 copies (past capacity 64); a random read; an empty
    read (best 0: every cell of its plane); a copy across 512."""
    rng = np.random.default_rng(15)
    ref = list(_seqs(rng, [600])[0])
    unit = "GATTACAGGCTA"
    for end in (128, 142, 262):
        ref[end - 12 : end] = unit
    ref[300:440] = "CA" * 70
    ref = "".join(ref)
    reads = [unit, "CA", _seqs(rng, [20])[0], "", ref[500:524]]
    return encode_batch(reads, 24, READ_PAD), encode_batch([ref], 600, REF_PAD)


@pytest.mark.parametrize("capacity", [1, 64])
@pytest.mark.parametrize("tie", TIES)
def test_fill_and_trace_matches_jax(tie, capacity):
    """Every output of fill_and_trace equals the JAX package's, pairs past
    the capacity included, with the reference broadcast (1, N) and per
    pair (B, N)."""
    reads, ref = _tied_pairs()
    refs = np.broadcast_to(ref, (reads.shape[0], ref.shape[1])).copy()
    cap = device_traceback.path_cap(24, 5, -4)
    want = [np.asarray(t) for t in jax_dt.fill_and_trace(
        reads, refs, *(np.int32(p) for p in PARAMS), capacity=capacity, cap=cap, tie_semantics=tie)]
    assert want[1][0] == 3 and want[1][1] > 64 and want[1][3] == 24 * 600
    for ref_in in (ref, refs):
        got = device_traceback.fill_and_trace(torch.from_numpy(reads), torch.from_numpy(ref_in), *PARAMS,
                                              capacity=capacity, cap=cap, tie_semantics=tie)
        assert [t.dtype for t in got] == [torch.int32] * 4 + [torch.int8]
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), w)


def _row(h_prev, rf, ch, west, above, match, mismatch, gap):
    """One DP row of a tile as the kernel's row step computes it (H and
    its a, ins, d candidates), west = H[i][base-1], above = H[i-1][base-1]."""
    nw = np.concatenate(([above], h_prev[:-1]))
    a = nw + np.where(rf == ch, match, mismatch)
    ins = h_prev + gap
    ramp = gap * np.arange(1, len(rf) + 1)
    h = np.maximum.accumulate(np.maximum(np.maximum(a, ins), 0) - ramp)
    h = np.maximum(h, west) + ramp  # column base-1 enters as west
    d = np.concatenate(([west], h[:-1])) + gap
    return h, a, ins, d


def _codes(h, a, ins, d, tie):
    order = ((a, 1), (ins, 2), (d, 3)) if tie == "serial" else ((d, 3), (ins, 2), (a, 1))
    code = np.zeros(len(h), np.int64)
    for cand, c in reversed(order):
        code = np.where(cand == h, c, code)
    return np.where(h > 0, code, 0)


def _walk(codes, stride, ci, cj, cap):
    """The kernel's walk over 2-bit codes, row-major, `stride` bytes a row."""
    out = np.zeros(cap, np.int8)
    i, j, begin = ci + 1, cj + 1, 0
    for s in range(cap):
        if i <= 0 or j <= 0:
            break
        v = (int(codes[(i - 1) * stride + (j - 1) // 4]) >> (2 * ((j - 1) % 4))) & 3
        if v == 0:
            break
        begin, out[s] = j, v
        i -= v in (1, 2)
        j -= v in (1, 3)
    return begin, out


def _block(read, ref, params, tie, cols, warps, cap, capacity=None, cell=None, order=1):
    """One block of csrc/fill_walk.cu in numpy: list mode (capacity) or
    known mode (cell).  Warps run in lock step, each step's warps one after
    another in ``order``: the kernel's buffers must make that order moot."""
    match, mismatch, gap = params
    m, n = len(read), len(ref)
    tile = 32 * cols
    tiles, stride = -(-n // tile), -(-n // tile) * tile // 4
    rounds = -(-tiles // warps)
    rows = m if cell is None else (cell[0] + 1 if 0 <= cell[0] < m and 0 <= cell[1] < n else 0)
    period = max(rows, warps)
    steps = (rounds - 1) * period + rows + warps - 1 if rows else 0
    ref_p = np.concatenate((ref.astype(np.int64), np.full(tiles * tile - n, REF_PAD)))
    codes = np.zeros(m * stride, np.uint8)
    wrap, nb = np.zeros(m, np.int64), np.zeros((2, warps), np.int64)
    state = [dict() for _ in range(warps)]
    lists, meta = {}, {}
    for s in range(steps):
        for w in (range(warps) if order > 0 else range(warps - 1, -1, -1)):
            r, i = divmod(s - w, period) if s >= w else (0, -1)
            t = r * warps + w
            if not (0 <= i < rows and r < rounds and t < tiles):
                continue
            st = state[w]
            if i == 0:
                st.update(h=np.zeros(tile, np.int64), above=0, tb=-1, tc=0)
                lists[t] = []
            west = 0 if t == 0 else wrap[i] if w == 0 else nb[(s - 1) & 1][w]
            h, a, ins, d = _row(st["h"], ref_p[t * tile : (t + 1) * tile], int(read[i]), west, st["above"], *params)
            code = _codes(h, a, ins, d, tie)
            js = t * tile + np.arange(tile)
            np.bitwise_or.at(codes, i * stride + js // 4, (code << 2 * (js % 4)).astype(np.uint8))
            valid = t * tile + np.arange(tile) < n
            top = h[valid].max()
            if top > st["tb"]:
                st["tb"], st["tc"] = top, 0
                lists[t] = []
            if top == st["tb"]:
                hits = np.flatnonzero(valid & (h == top))
                lists[t] += [(i, t * tile + k) for k in hits][: max(0, (capacity or 0) - len(lists[t]))]
                st["tc"] += len(hits)
            if i == rows - 1:
                meta[t] = (st["tb"], st["tc"])
            if t + 1 < tiles:
                if w == warps - 1:
                    wrap[i] = h[-1]
                else:
                    nb[s & 1][w + 1] = h[-1]
            st["h"], st["above"] = h, west
    if cell is not None:
        return _walk(codes, stride, *cell, cap) if rows else (0, np.zeros(cap, np.int8))
    best = max(b for b, _ in meta.values())
    count = sum(c for b, c in meta.values() if b == best)
    if best == 0:
        cells = [(p // n, p % n) for p in range(min(capacity, m * n))]
    else:
        cells = sorted(c for t in range(tiles) if meta[t][0] == best for c in lists[t])[:capacity]
    walks = [_walk(codes, stride, ci, cj, cap) if best else (0, np.zeros(cap, np.int8)) for ci, cj in cells]
    pad = capacity - len(cells)
    return (best, count, np.array(cells + [(-1, -1)] * pad, np.int32).reshape(capacity, 2),
            np.array([b for b, _ in walks] + [0] * pad, np.int32),
            np.concatenate([np.stack([c for _, c in walks]).reshape(-1, cap), np.zeros((pad, cap), np.int8)]))


@pytest.mark.parametrize("cols, warps", [(4, 2), (4, 3), (16, 1)])
def test_block_model_lists_like_argwhere(cols, warps):
    """The kernel's block in list mode equals fill_list's plain version
    (fill_pairs, argwhere_rows, the plain walk) on every pair of
    ``_tied_pairs`` and on a 2-row read over five tiles, in both tie
    orders and either order of a step's warps: tiles of 128 columns in two
    rounds (the column between rounds), with three warps (a pair of fewer
    rows than warps: the round's delay), and one warp of 512."""
    reads, ref = _tied_pairs()
    rng = np.random.default_rng(3)
    short_ref = encode_batch(_seqs(rng, [600]), 600, REF_PAD)
    cases = [(reads, ref), (encode_batch(["AC"], 2, READ_PAD), short_ref)]
    cap = device_traceback.path_cap(24, 5, -4)
    for (rd, rf), tie in [(c, t) for c in cases for t in TIES]:
        want = cuda_score.fill_list(torch.from_numpy(rd), torch.from_numpy(rf), *PARAMS, capacity=4, cap=cap,
                                    tie_semantics=tie)
        for p in range(rd.shape[0]):
            for order in (1, -1):
                got = _block(rd[p], rf[0], PARAMS, tie, cols, warps, cap, capacity=4, order=order)
                for g, w in zip(got, want):
                    np.testing.assert_array_equal(np.asarray(g), w[p].numpy())


def test_block_model_walks_known_cells():
    """Known mode: the fill stops at the cell's row, and the walk equals
    fill_walk's plain version; the cell (-1, -1) walks no step."""
    rng = np.random.default_rng(7)
    ref = _seqs(rng, [300])[0]
    reads = [ref[200:230], ref[40:52] + "T" + ref[52:70], "".join(_seqs(rng, [30]))]
    rd = encode_batch(reads, 31, READ_PAD)
    windows = encode_batch([ref[160:230], ref[0:70], ref[:70]], 70, REF_PAD)
    cells = np.array([[29, 69], [30, 69], [-1, -1]], np.int32)
    for tie in TIES:
        want_b, want_c = cuda_score.fill_walk(torch.from_numpy(rd), torch.from_numpy(windows),
                                              torch.from_numpy(cells), *PARAMS, cap=100, tie_semantics=tie)
        assert want_b[0] > 0 and want_b[2] == 0
        for p in range(3):
            begin, codes = _block(rd[p], windows[p], PARAMS, tie, 4, 2, 100, cell=tuple(cells[p]))
            assert begin == want_b[p]
            np.testing.assert_array_equal(codes, want_c[p].numpy())


def test_fill_plan():
    """The warps a pair and the tile width at the main path's shapes (a
    card of 132 SMs): few pairs spread over several warps in one round of
    narrow tiles, a busy card takes wide ones, many pairs one warp of
    512-column tiles; and fill_route, which keeps a pair's codes in
    shared memory where every block of the launch finds room at once."""
    plan = cuda_score.fill_plan
    assert plan(64, 512, 132) == (4, 4)       # 64 windows of 512 columns: 4 tiles of 128
    assert plan(512, 512, 132) == (16, 1)     # a full window dispatch: one warp of 512 columns
    assert plan(215, 2048, 132) == (16, 4)    # a full-fill chunk against a 2 kb ref: 4 tiles of 512
    assert plan(107, 4096, 132) == (16, 8)    # against a 4 kb ref
    assert plan(64, 4096, 132) == (16, 8)     # the same at 256 rows
    assert plan(4, 5632, 132) == (16, 11)     # 4 long windows: 11 tiles of 512, one round
    assert plan(1, 131_072, 132) == (16, 16)  # one pair, 256 tiles: 16 rounds of 16 warps
    assert plan(5000, 512, 132) == (16, 1) and plan(1, 1, 132) == (4, 1)
    for b, n in ((1, 100), (4, 5632), (64, 512), (512, 2048), (10_000, 4096)):
        cols, warps = plan(b, n, 132)
        tiles = -(-n // (32 * cols))
        assert cols in cuda_score._FILL_COLS and 1 <= warps <= min(tiles, cuda_score._FILL_MAX_WARPS)
        assert b * warps <= max(b, cuda_score._FILL_WARPS_PER_SM * 132)
    route = cuda_score.fill_route
    assert route(64, 150 * 128, 9, 132) == route(512, 150 * 128, 9, 132) == "shared"  # windows of 512 columns
    assert route(215, 152 * 512, 2, 132) == "shared"    # 2 kb: two blocks an SM, one wave
    assert route(215, 152 * 512, 1, 132) == "scratch"   # the same where the listing's keys leave room for one
    assert route(512, 152 * 1024, 1, 132) == "scratch"  # 4 kb: one block an SM would take four waves
    assert route(4, 2048 * 1408, 0, 132) == "scratch"   # long windows: 2.9 MB a pair
    assert route(1, cuda_score._FILL_SMEM_CODES + 1, 1, 132) == "scratch"


@pytest.mark.parametrize("tie", TIES)
def test_fill_walk_known_matches_jax(tie):
    """longseq._fill_walk_known equals the JAX package's on windows built
    as sites_for_ref_long_batched builds them (REF_PAD on the left), cells
    in the last column and inside, a cell past the read's rows, and a walk
    cut by its cap."""
    rng = np.random.default_rng(21)
    ref = _seqs(rng, [400])[0]
    lens = [30, 22, 17, 30]
    ends = [400, 40, 250, 120]
    reads = [ref[e - k : e] for k, e in zip(lens, ends)]
    reads[1] = reads[1][:10] + "A" + reads[1][10:]
    windows = np.full((4, 96), REF_PAD, np.uint8)
    for t, e in enumerate(ends):
        piece = ref[max(0, e - 90) : e]
        windows[t, 96 - len(piece) :] = encode_batch([piece], len(piece), REF_PAD)[0]
    rd = encode_batch(reads, 31, READ_PAD)
    cells = np.array([[29, 95], [22, 95], [10, 60], [30, 95]], np.int32)
    for cap in (31 + 96, 12):
        want_b, want_c = (np.asarray(t) for t in jax_longseq._fill_walk_known(
            rd, windows, cells, *(np.int32(p) for p in PARAMS), cap=cap, tie_semantics=tie))
        got_b, got_c = longseq._fill_walk_known(torch.from_numpy(rd), torch.from_numpy(windows),
                                                torch.from_numpy(cells), *PARAMS, cap=cap, tie_semantics=tie)
        np.testing.assert_array_equal(got_b.numpy(), want_b)
        np.testing.assert_array_equal(got_c.numpy(), want_c)
    assert (want_c[:, -1] != 0).any() and want_b[0] > 0


def test_new_wrappers_refuse_malformed_inputs():
    reads = torch.zeros((3, 4), dtype=torch.uint8)
    refs = torch.ones((3, 9), dtype=torch.uint8)
    cells = torch.zeros((3, 2), dtype=torch.int32)
    good = dict(capacity=2, cap=8, tie_semantics="serial")
    for args, kw in (((reads.to(torch.int32), refs), {}), ((reads, refs[:2]), {}), ((reads, refs[0]), {}),
                     ((reads[:, :0], refs), {}), ((reads, refs[:, :0]), {}), ((reads, refs), dict(capacity=0)),
                     ((reads, refs), dict(cap=-1)), ((reads, refs), dict(tie_semantics="last"))):
        with pytest.raises(ValueError):
            cuda_score.fill_list(*args, *PARAMS, **{**good, **kw})
    good = dict(cap=8, tie_semantics="serial")
    for args, kw in (((reads, refs, cells[:2]), {}), ((reads, refs, cells.to(torch.int64)), {}),
                     ((reads, refs, cells[:, :1]), {}), ((reads, refs[:2], cells), {}),
                     ((reads, refs, cells), dict(cap=-1)), ((reads, refs, cells), dict(tie_semantics="x"))):
        with pytest.raises(ValueError):
            cuda_score.fill_walk(*args, *PARAMS, **{**good, **kw})
    for cell in ((4, 0), (0, 9), (-1, 0), (0, -2)):  # outside the (4, 9) plane and not (-1, -1)
        bad = cells.clone()
        bad[1] = torch.tensor(cell)
        for wrapper in (cuda_score.fill_walk, cuda_score.fill_walk_plain):
            with pytest.raises(ValueError):
                wrapper(reads, refs, bad, *PARAMS, **good)
    with pytest.raises(ValueError):
        cuda_score._fill_walk(reads, refs, cells, *PARAMS, **good, route="disk")
    with pytest.raises(ValueError):
        cuda_score._fill_list(reads, refs, *PARAMS, **dict(good, capacity=2), route="disk")
    best, counts, listed, begins, codes = cuda_score.fill_list(reads, refs[:1], *PARAMS, **dict(good, capacity=2))
    assert not best.any() and (counts == 36).all() and listed[0].tolist() == [[0, 0], [0, 1]] and not codes.any()
