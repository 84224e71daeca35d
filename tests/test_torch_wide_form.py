"""K1's and K4's 16-bit form on rows wider than one pass: the rule that
picks it, the plain versions it is held to, a model of its stripes and
the host plans around it.

``cuda_score.k1k4_form`` gives K1 (packed rows) and K4 (unpacked reads)
the s16x2 form past ``ONE_PASS_LANES`` where the longest segment's
scores fit int16 and mismatch and gap are negative; the striped 16-bit
kernels (``lane_best_wide_s16x2_kernel``, ``score_grid_wide_s16x2_kernel``)
run only on the card, where ``chip_smoke.py`` [14] holds them to the same
plain versions and to the int32 striped kernels.  Here the plain
versions are held to the JAX row recurrence, a 16-bit model of the
stripes to the plain version, and the batch backend is shown to hand K1
its longest read from the host.  Tolerance 0 throughout: scores are
integers.
"""

import numpy as np
import pytest
import torch

from sparksmithwaterman_tpu.ops.recurrence import score_grid as jax_score_grid
from sparksmithwaterman_tpu_torch.config import AlignConfig, ScoringScheme
from sparksmithwaterman_tpu_torch.io.fasta import READ_PAD, REF_PAD, encode_batch, encode_concat
from sparksmithwaterman_tpu_torch.models import batch_backend
from sparksmithwaterman_tpu_torch.models.batch_backend import TorchBatchBackend
from sparksmithwaterman_tpu_torch.ops import cuda_score
from sparksmithwaterman_tpu_torch.ops.packing import START_BIT, pack_reads, read_best

torch.set_num_threads(1)

PARAMS = (5, -3, -4)
_BASES = np.array(list("ACGT"))


def _seqs(rng, lens):
    return ["".join(rng.choice(_BASES, size=int(n))) for n in lens]


def _mutated(rng, seq, rate=1 / 30):
    arr = np.array(list(seq))
    hit = rng.random(arr.size) < rate
    arr[hit] = rng.choice(_BASES, size=int(hit.sum()))
    return "".join(arr)


def _jax_best(reads, refs, params):
    m = max(map(len, reads))
    n = max(map(len, refs))
    return np.asarray(jax_score_grid(encode_batch(reads, m, READ_PAD), encode_batch(refs, n, REF_PAD), *params))


def _k1_plain(reads, refs, m, params, longest=None):
    """Per-read best (R, C) through K1's wrapper on the CPU (its plain
    version), reads packed at m lanes, the refs in one flat buffer."""
    packed, start = pack_reads(reads, m)
    flat, lens = encode_concat(refs)
    offs = np.concatenate(([0], np.cumsum(lens)[:-1])).astype(np.int64)
    out = cuda_score.lane_best_packed_varlen(
        torch.from_numpy(packed), torch.from_numpy(flat), torch.from_numpy(lens.astype(np.int32)), *params,
        offsets=torch.from_numpy(offs), longest=longest,
    )
    return read_best(out, start).numpy()


def _wide_reads(rng, m, refs):
    """Reads across and on the stripe borders of an m-lane row (every 256
    lanes in the s16x2 form, 512 in the int32 one): one over every
    stripe, 255-257 and 511-513 bp, 2 bp, mutated pieces of the refs (so
    they score high), and random lengths."""
    reads = _seqs(rng, [m, 255, 256, 257, 511, 512, 513, 2, 1]) + [_mutated(rng, r) for r in refs]
    reads += _seqs(rng, rng.integers(1, m + 1, 4))
    return reads


@pytest.mark.parametrize("kernel", ["K1", "K4"])
def test_k1k4_form_at_the_edges_of_its_rule(kernel):
    """The rule past one pass, for both kernels (and K2's): match x the
    longest segment <= 32,767, mismatch < 0 and gap < 0; k1_form (K5's
    and K8's up to one pass) unchanged."""
    form = cuda_score.k1k4_form
    for m in (1025, 4096, 6553):
        assert form(m, *PARAMS) == "s16x2", m  # 5 x 6,553 = 32,765
        assert cuda_score.k1_form(m, *PARAMS) == "int32", m
    assert form(6554, *PARAMS) == "int32"  # 5 x 6,554 = 32,770
    assert form(1024, 32, -3, -4) == cuda_score.k1_form(1024, 32, -3, -4) == "int32"
    assert form(1024, 31, -3, -4) == cuda_score.k1_form(1024, 31, -3, -4) == "s16x2"
    for params in ((5, 0, -4), (5, -3, 0), (5, 1, -4), (5, -3, -32769)):
        assert form(4096, *params) == "int32", params
    assert form(2048, 15, -3, -4) == "s16x2" and form(2048, 16, -3, -4) == "int32"  # 30,720 and 32,768
    assert form(2048, 15, -32768, -32768) == "s16x2"
    if kernel == "K1":
        # A read of 4,097-6,553 bp sits in an 8,192-lane row: its width
        # alone says int32, its longest segment s16x2.
        assert form(8192, *PARAMS) == "int32"
        assert form(8192, *PARAMS, longest=6553) == "s16x2"
        assert form(8192, *PARAMS, longest=6554) == "int32"
        assert form(16384, *PARAMS, longest=6553) == "s16x2"
        assert form(2048, 26, -3, -4, longest=1260) == "s16x2" and form(2048, 26, -3, -4, longest=1261) == "int32"
        # longest never raises the bound past the row, and 0 counts as 1.
        assert form(2048, 15, -3, -4, longest=10**6) == "s16x2" and form(2048, 16, -3, -4, longest=10**6) == "int32"
        assert form(2048, 32767, -3, -4, longest=0) == "s16x2"
    else:
        # K4's m is the read group's width, already its longest read.
        assert form(1300, 25, -3, -4) == "s16x2" and form(1300, 26, -3, -4) == "int32"


def test_private_entries_take_the_16bit_form_only_inside_the_rule():
    """The A/B entries accept ``form="s16x2"`` on wide rows exactly where
    k1k4_form says so (K1 with its longest read, K2 and K4) or k5_form (K5),
    and K8, which takes k5_form too, refuses it past 6,553 positions."""
    rng = np.random.default_rng(3)
    (ref,) = _seqs(rng, [300])
    packed, _ = pack_reads([ref, ref[:40]], 2048)
    flat, lens = encode_concat([ref])
    k1 = (torch.from_numpy(packed), torch.from_numpy(flat), torch.from_numpy(lens.astype(np.int32)))
    offs = torch.zeros(1, dtype=torch.int64)
    want = cuda_score.lane_best_packed_varlen_plain(*k1, 26, -3, -4, offs)
    got = cuda_score._lane_best_packed_varlen(*k1, 26, -3, -4, offs, longest=1260, form="s16x2")
    np.testing.assert_array_equal(got, want)
    for longest in (None, 1261):
        with pytest.raises(ValueError, match="cannot take form"):
            cuda_score._lane_best_packed_varlen(*k1, 26, -3, -4, offs, longest=longest, form="s16x2")
    reads = torch.from_numpy(encode_batch([ref, ref[:100]], 1025, READ_PAD))
    refs = torch.from_numpy(encode_batch([ref], 300, REF_PAD))
    np.testing.assert_array_equal(cuda_score._score_grid_diag(reads, refs, *PARAMS, form="s16x2"),
                                  cuda_score.score_grid_diag_plain(reads, refs, *PARAMS))
    wide = torch.from_numpy(encode_batch([ref], 6554, READ_PAD))
    with pytest.raises(ValueError, match="cannot take form"):
        cuda_score._score_grid_diag(wide, refs, *PARAMS, form="s16x2")
    np.testing.assert_array_equal(cuda_score._score_grid_row(reads, refs, *PARAMS, form="s16x2"),
                                  cuda_score.score_grid_diag_plain(reads, refs, *PARAMS))
    for got, want in zip(cuda_score._argmax_lane(reads, refs, *PARAMS, form="s16x2"),
                         cuda_score.argmax_lane_plain(reads, refs, *PARAMS)):
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="cannot take form"):
        cuda_score._score_grid_row(wide, refs, *PARAMS, form="s16x2")
    with pytest.raises(ValueError, match="cannot take form"):
        cuda_score._argmax_lane(wide, refs, *PARAMS, form="s16x2")
    best = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="cannot take form"):
        cuda_score._max_cells_row(wide, refs[0], best, *PARAMS, 4, form="s16x2")


@pytest.mark.parametrize("m", [1025, 2100])
def test_k1_plain_on_wide_rows_matches_jax(m):
    """K1's plain version (what both striped forms compute) at rows past
    one pass, reads across the stripe borders, against the JAX row
    recurrence at every read."""
    rng = np.random.default_rng(m)
    refs = _seqs(rng, [350, 1, 120])
    reads = _wide_reads(rng, m, refs)
    assert cuda_score.k1k4_form(m, *PARAMS, longest=max(map(len, reads))) == "s16x2"
    np.testing.assert_array_equal(_k1_plain(reads, refs, m, PARAMS), _jax_best(reads, refs, PARAMS))


@pytest.mark.parametrize("m", [1025, 2100])
def test_k4_plain_on_wide_reads_matches_jax(m):
    """K4's plain version on reads past one pass (the tensor m wide), the
    reads of the K1 case, against the JAX row recurrence at every pair."""
    rng = np.random.default_rng(m + 1)
    refs = _seqs(rng, [350, 1, 120])
    reads = _wide_reads(rng, m, refs)
    assert cuda_score.k1k4_form(m, *PARAMS) == "s16x2"
    got = cuda_score.score_grid_diag(torch.from_numpy(encode_batch(reads, m, READ_PAD)),
                                     torch.from_numpy(encode_batch(refs, 350, REF_PAD)), *PARAMS)
    np.testing.assert_array_equal(got, _jax_best(reads, refs, PARAMS))


def _stripe_model(packed, refs, params, stripe=cuda_score.STRIPE16_LANES):
    """(C, ROWS, M) lane bests of the striped 16-bit kernels, modelled on
    the CPU: each row swept stripe by stripe, every value wrapped to int16
    as a 16-bit half wraps; lane 0 of a later stripe takes its N term from
    the carry row of the stripe above (columns [0, len), 0 elsewhere) and
    drops it only where its lane has START_BIT; each stripe runs its lanes
    + len - 1 diagonals rounded up to the unroll of 2, the last lane
    stored for columns below len only.  Then the segmented suffix max over
    the row (each stripe's own, then across the borders)."""
    match, mismatch, gap = params
    rows, m = packed.shape
    code = packed & (START_BIT - 1)
    start = packed >= START_BIT
    start[:, 0] = True

    def wrap(x):
        return (x + 32768) % 65536 - 32768

    out = []
    for ref in refs:
        n = len(ref)
        ref_c = torch.from_numpy(encode_batch([ref], max(1, n), REF_PAD)[0].astype(np.int64))
        best = torch.zeros((rows, m), dtype=torch.int64)
        carry = torch.zeros((rows, n), dtype=torch.int64)
        for base in range(0, m, stripe):
            lanes = min(stripe, m - base)
            rd = torch.full((rows, stripe), READ_PAD, dtype=torch.int64)
            rd[:, :lanes] = code[:, base : base + lanes]
            keep = torch.zeros((rows, stripe), dtype=torch.bool)
            keep[:, :lanes] = ~start[:, base : base + lanes]
            h = torch.zeros((rows, stripe), dtype=torch.int64)
            u = torch.zeros_like(h)
            below = torch.zeros((rows, n), dtype=torch.int64)
            nd = lanes + n - 1 if n else 0
            for d in range(nd + nd % 2):
                j = d - torch.arange(stripe)
                col = torch.where((j >= 0) & (j < n), ref_c[j.clamp(0, max(0, n - 1))], REF_PAD)
                sub = torch.where(rd == col, match, mismatch)
                lane0 = carry[:, d] if d < n else torch.zeros(rows, dtype=torch.int64)
                up = torch.cat([lane0[:, None], h[:, :-1]], 1) * keep
                h, u = wrap(torch.maximum(torch.maximum(wrap(u + sub), wrap(torch.maximum(up, h) + gap)),
                                          torch.zeros(()))), up
                best[:, base : base + lanes] = torch.maximum(best[:, base : base + lanes], h[:, :lanes])
                if 0 <= d - (stripe - 1) < n:
                    below[:, d - (stripe - 1)] = h[:, stripe - 1]
            carry = below
        out.append(cuda_score.segmented_suffix_max(best, packed >= START_BIT))
    return torch.stack(out).to(torch.int32)


def test_stripe_model_matches_plain():
    """The model of the striped 16-bit kernels equals K1's plain version
    at every start lane: 1,100-lane rows (stripes of 256, four, then 76
    lanes), reads crossing the borders, starting on them and 1-2 bp long."""
    rng = np.random.default_rng(17)
    refs = _seqs(rng, [180, 1, 60])
    reads = _seqs(rng, [1100, 700, 400, 255, 2, 587, 256, 1, 300, 513]) + [_mutated(rng, refs[0])]
    packed, start = pack_reads(reads, 1100)
    flat, lens = encode_concat(refs)
    offs = torch.from_numpy(np.concatenate(([0], np.cumsum(lens)[:-1])).astype(np.int64))
    plain = cuda_score.lane_best_packed_varlen_plain(torch.from_numpy(packed), torch.from_numpy(flat),
                                                     torch.from_numpy(lens.astype(np.int32)), *PARAMS, offs)
    model = _stripe_model(torch.from_numpy(packed).to(torch.int64), refs, PARAMS)
    np.testing.assert_array_equal(read_best(model, start), read_best(plain, start))


@pytest.mark.parametrize("match", [25, 26])
def test_read_equal_to_its_ref_at_the_int16_edge(match):
    """A 1,300 bp read equal to its reference scores match x 1,300: 32,500
    at match 25 (s16x2 for both kernels: K1 by its longest read in a
    2,048-lane row, K4 at 1,300 positions) and 33,800 at match 26 (int32).
    The plain versions and the JAX recurrence agree; the 16-bit model of
    the stripes keeps 32,500 and wraps at 33,800, which is why the rule
    stops there."""
    rng = np.random.default_rng(match)
    (ref,) = _seqs(rng, [1300])
    params = (match, -3, -4)
    form = "s16x2" if match == 25 else "int32"
    assert cuda_score.k1k4_form(2048, *params, longest=1300) == cuda_score.k1k4_form(1300, *params) == form
    reads = [ref, ref[200:1250]]
    want = _jax_best(reads, [ref], params)
    assert want[0, 0] == match * 1300
    np.testing.assert_array_equal(_k1_plain(reads, [ref], 2048, params, longest=1300), want)
    got4 = cuda_score.score_grid_diag(torch.from_numpy(encode_batch(reads, 1300, READ_PAD)),
                                      torch.from_numpy(encode_batch([ref], 1300, REF_PAD)), *params)
    np.testing.assert_array_equal(got4, want)
    packed, start = pack_reads([ref], 1300)
    model = read_best(_stripe_model(torch.from_numpy(packed).to(torch.int64), [ref], params), start)
    assert (int(model[0, 0]) == match * 1300) == (form == "s16x2")


def test_pair_carry_sizing_and_parts():
    """The s16x2 form's carry scratch: two rows of 32-bit words (both
    halves) per pair, rows in blocks of eight; never more than the int32
    form's (the backends' chunk plans keep those as an upper bound); and
    the rows a launch takes are whole blocks of eight."""
    assert cuda_score.carry_elems(1024, 5, 100, pair=True) == 0
    assert cuda_score.carry_elems(1025, 5, 100, pair=True) == 8 * 100  # one pair block: 4 pairs x 2 rows
    assert cuda_score.carry_elems(1025, 9, 100, pair=True) == 16 * 100
    for rows in range(1, 40):
        assert cuda_score.carry_elems(2048, rows, 7, pair=True) <= cuda_score.carry_elems(2048, rows, 7)
    assert cuda_score.carry_rows(10, 0, pair=True) == 16
    assert cuda_score.carry_rows(10, cuda_score.carry_elems(2048, 10, 10**6, pair=True), pair=True) == 16
    budget = cuda_score.CARRY_BUDGET
    # One 1 Mb reference against 1,100 rows: 8 M words a block of 8, 33 blocks fit.
    elems = cuda_score.carry_elems(2048, 1100, 10**6, pair=True)
    part = cuda_score.carry_rows(1100, elems, pair=True)
    assert elems > budget and part == 8 * (budget // (8 * 10**6)) == 264
    assert cuda_score.carry_elems(2048, part, 10**6, pair=True) <= budget
    assert cuda_score.carry_elems(2048, part + 8, 10**6, pair=True) > budget
    assert cuda_score.carry_rows(1100, cuda_score.carry_elems(4096, 1100, budget, pair=True), pair=True) == 8
    # K1's scratch and per-reference offsets for a pair launch.
    cols = torch.tensor([300, 0, 45], dtype=torch.int32)
    scratch, offs, part = cuda_score._carry_rows(2048, 13, cols, None, pair=True)
    assert part == 16 and scratch.numel() == 16 * 345 and offs.tolist() == [0, 16 * 300, 16 * 300]
    assert cuda_score._carry_rows(1024, 13, cols, 345, pair=True) == (None, None, 0)


def test_batch_backend_hands_k1_its_longest_read(monkeypatch):
    """A file whose longest read is 1,500 bp packs into 2,048-lane rows.
    The batch backend hands K1's wrapper ``longest=1500``, a host integer
    from the reads, so that at match 20 (20 x 2,048 past int16, 20 x 1,500
    inside) the wide rows take the 16-bit form; the dispatch reads nothing
    back from a tensor, and the totals equal the JAX recurrence's."""
    rng = np.random.default_rng(5)
    refs = _seqs(rng, [400, 250, 1600])
    reads = _seqs(rng, [90] * 12 + [300] * 3) + [_mutated(rng, refs[2][:1500])]
    params = (20, -3, -4)
    config = AlignConfig(ref_dir="", in_dir="", out_dir="", scoring=ScoringScheme(*params))
    calls = []
    real = batch_backend.lane_best_packed_varlen

    def spy(packed, refs_u8, lens, *args, **kw):
        calls.append((packed.shape[1], kw.get("longest")))
        return real(packed, refs_u8, lens, *args, **kw)

    monkeypatch.setattr(batch_backend, "lane_best_packed_varlen", spy)
    backend = TorchBatchBackend(config, "cpu")
    got = backend.totals(reads, refs)
    assert calls and all(m == 2048 and type(longest) is int and longest == 1500 for m, longest in calls)
    assert cuda_score.k1k4_form(2048, *params) == "int32"
    assert cuda_score.k1k4_form(2048, *params, longest=1500) == "s16x2"
    np.testing.assert_array_equal(got, _jax_best(reads, refs, params).sum(axis=0))

    def read_back(*_a, **_k):
        raise AssertionError("the dispatch read a tensor back")

    monkeypatch.setattr(batch_backend, "lane_best_packed_varlen",
                        lambda packed, refs_u8, lens, *a, **kw: torch.zeros((lens.shape[0],) + tuple(packed.shape),
                                                                            dtype=torch.int32))
    for name in ("item", "tolist", "numpy", "__int__", "__index__", "__bool__"):
        monkeypatch.setattr(torch.Tensor, name, read_back)
    pending, _ = backend._dispatch_packed(reads, refs)
    assert len(pending) == len(calls)
