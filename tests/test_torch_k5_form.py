"""K5's two forms and its column segments: the rule that picks the 16-bit
form, a plain model of that form's arithmetic, and the plan that splits a
long reference over blocks.

``cuda_score.score_grid_row`` takes the s16x2 form (two reads per warp in
the 16-bit halves of each register) exactly when ``cuda_score.k5_form``
(``cuda_score.k1_form`` up to 1,024 positions, then the same bound at
any width) says every score fits int16, with m the width of the reads
tensor; the
kernels run only on the card (``chip_smoke.py`` [0], [8]).  Here
:func:`_row_s16x2_model` computes what that kernel computes, in 16-bit
values wrapped after every add: the tiles, the lanes, the decaying scan
with its clamped constants and the carried column.  It is held to the
JAX row kernel (``pallas_score_grid``, interpret mode) and to the JAX row
recurrence at the rule's edges, where the int32 form's ramp, done in 16
bits, overflows.  The segment plan (``cuda_score.row_segments``) is held
by running the plain recurrence on each segment and taking the max.
Tolerance 0 throughout: scores are integers.
"""

import inspect

import numpy as np
import pytest
import torch

from sparksmithwaterman_tpu.ops.pallas_score import pallas_score_grid
from sparksmithwaterman_tpu.ops.recurrence import score_grid as jax_score_grid
from sparksmithwaterman_tpu_torch.io.fasta import READ_PAD, REF_PAD, encode_batch
from sparksmithwaterman_tpu_torch.ops import cuda_score
from sparksmithwaterman_tpu_torch.ops.recurrence import score_grid

torch.set_num_threads(1)

PARAMS = (5, -3, -4)
_BASES = np.array(list("ACGT"))


def _seqs(rng, lens, bases=_BASES):
    return ["".join(rng.choice(bases, size=int(n))) for n in lens]


def _grid(reads, refs, m=None):
    m = max(map(len, reads)) if m is None else m
    n = max(1, max(map(len, refs)))
    return torch.from_numpy(encode_batch(reads, m, READ_PAD)), torch.from_numpy(encode_batch(refs, n, REF_PAD))


def _jax(reads_t, refs_t, params):
    return np.asarray(jax_score_grid(reads_t.numpy(), refs_t.numpy(), *params))


def _wrap(x):
    """x as a 16-bit half of a register holds it (two's complement)."""
    return torch.remainder(x + 32768, 65536) - 32768


def _addmax_relu(a, b, c):
    """__viaddmax_s16x2_relu on one half: max(a + b wrapped, c, 0)."""
    return torch.maximum(_wrap(a + b), c).clamp_min(0)


def _row_s16x2_model(reads_t, refs_t, match, mismatch, gap, *, lanes=32, cols=16, ramp=False):
    """(R, C) best scores as K5's s16x2 form computes them: tiles of lanes
    x cols columns, every row of a tile before the next, one carried
    column between tiles, every value a 16-bit half (int64 tensors wrapped
    after each add).  ``ramp=True`` resolves the gap chain as the int32
    form does, a prefix max of A[k] - gap k over the tile, in the same 16
    bits.  Pad rows and columns are swept, as the kernel sweeps a pair to
    its longer read and a tile to its end."""
    r, m = reads_t.shape
    c, n = refs_t.shape
    tile = lanes * cols
    reads_i = reads_t.to(torch.int64)
    refs_i = torch.nn.functional.pad(refs_t.to(torch.int64), (0, -n % tile), value=REF_PAD)
    lane = torch.arange(lanes)
    scan = [max(gap * cols * (1 << q), -32768) for q in range(lanes.bit_length() - 1)]
    ramp_k = gap * torch.arange(tile)
    best = torch.zeros((r, c), dtype=torch.int64)
    carry = torch.zeros((r, c, m), dtype=torch.int64)  # H[i][last column of the tile before]
    for base in range(0, n, tile):
        ref_cols = refs_i[:, base : base + tile].reshape(1, c, lanes, cols)
        h = torch.zeros((r, c, lanes, cols), dtype=torch.int64)
        above = torch.zeros((r, c), dtype=torch.int64)
        for i in range(m):
            west = carry[:, :, i].clone()
            nw = torch.cat([above[..., None], h.reshape(r, c, tile)[..., :-1]], -1).reshape(h.shape)
            # The IMAD: U + (match - mismatch) where the codes are equal, in
            # one unsigned half (no carry into the other); then + mismatch.
            v = (reads_i[:, i, None, None, None] == ref_cols).to(torch.int64) * (match - mismatch) + nw
            assert ramp or 0 <= int(v.min()) and int(v.max()) <= 0xFFFF
            a = torch.maximum(_wrap(_wrap(v) + mismatch), _wrap(h + gap)).clamp_min(0)
            if ramp:
                x = torch.cat([_wrap(west + gap)[..., None], _wrap(a.reshape(r, c, tile) - ramp_k)], -1)
                h = _wrap(torch.cummax(x, -1).values[..., 1:] + ramp_k).reshape(h.shape)
            else:
                run = _addmax_relu(torch.where(lane == 0, west[..., None], 0), gap, a[..., 0])
                for k in range(1, cols):
                    run = _addmax_relu(run, gap, a[..., k])
                for q, g in enumerate(scan):
                    s = 1 << q
                    shifted = torch.nn.functional.pad(run[..., :-s], (s, 0))
                    run = torch.where(lane >= s, _addmax_relu(shifted, g, run), run)
                incoming = torch.cat([west[..., None], run[..., :-1]], -1)
                h = a.clone()
                h[..., 0] = _addmax_relu(incoming, gap, a[..., 0])
                for k in range(1, cols):
                    h[..., k] = _addmax_relu(h[..., k - 1], gap, a[..., k])
            best = torch.maximum(best, h.amax(dim=(-1, -2)))
            above = west
            carry[:, :, i] = h[..., -1, -1]
    return best.to(torch.int32)


def _split_best(reads_t, refs_t, params, stride, length):
    """The plain recurrence on every segment [k stride, k stride + length)
    of the references, maxed over segments."""
    n = refs_t.shape[1]
    best = torch.zeros((reads_t.shape[0], refs_t.shape[0]), dtype=torch.int32)
    for j0 in range(0, n, stride):
        best = torch.maximum(best, score_grid(reads_t, refs_t[:, j0 : j0 + length], *params))
    return best


@pytest.mark.parametrize(
    "m, params, form",
    [
        (1024, (31, -3, -4), "s16x2"),  # 31 x 1,024 = 31,744 fits
        (1024, (32, -3, -4), "int32"),  # 32 x 1,024 = 32,768 does not
        (1025, (5, -3, -4), "s16x2"),  # wider than one pass: the row form has no stripes (k5_form)
        (150, (5, -3, -32768), "s16x2"),
        (150, (5, -3, -32769), "int32"),
    ],
)
def test_k5_form_at_the_edges_of_its_rule(m, params, form):
    """The rule at K5's widths, and the private entry of the A/B refusing
    the s16x2 form exactly where the rule says int32."""
    assert cuda_score.k5_form(m, *params) == form
    reads_t, refs_t = _grid(["ACGT"], ["ACGTT"], m)
    want = score_grid(reads_t, refs_t, *params)
    np.testing.assert_array_equal(cuda_score._score_grid_row(reads_t, refs_t, *params, form="int32"), want)
    if form == "s16x2":
        np.testing.assert_array_equal(cuda_score._score_grid_row(reads_t, refs_t, *params, form="s16x2"), want)
    else:
        with pytest.raises(ValueError):
            cuda_score._score_grid_row(reads_t, refs_t, *params, form="s16x2")


def test_s16x2_model_matches_the_jax_row_kernel():
    """The 16-bit model, in the kernel's tile (32 lanes x 16 columns) and
    in tiles of 4 x 4 (so that columns cross lanes and tiles), against
    ``pallas_score_grid`` in interpret mode: an odd read count with an
    empty and a 1 bp read, refs of 1-60 bp."""
    rng = np.random.default_rng(21)
    reads = _seqs(rng, rng.integers(2, 24, 5)) + ["", "T"]
    refs = _seqs(rng, [1, 37, 60, 12])
    reads_t, refs_t = _grid(reads, refs, 24)
    want = np.asarray(pallas_score_grid(reads_t.numpy(), refs_t.numpy(), *PARAMS, read_block=7, interpret=True))
    np.testing.assert_array_equal(_row_s16x2_model(reads_t, refs_t, *PARAMS).numpy(), want)
    np.testing.assert_array_equal(_row_s16x2_model(reads_t, refs_t, *PARAMS, lanes=4, cols=4).numpy(), want)
    np.testing.assert_array_equal(cuda_score.score_grid_row(reads_t, refs_t, *PARAMS).numpy(), want)
    assert not want[5].any()  # the empty read


@pytest.mark.parametrize("params", [(4681, -3, -3000), (4681, -32768, -32768)])
def test_s16x2_model_at_the_rules_edges_where_the_ramp_overflows(params):
    """At 7 bp reads and match 4,681 (match x m = 32,767, the rule's
    largest), with a gap whose scan steps across lanes need the clamp at
    -32,768 (gap x 16 = -48,000) and at gap = mismatch = -32,768, the
    16-bit model equals the JAX and the port's row recurrence; the ramp
    in the same 16 bits does not, which is why the s16x2 form scans with a
    decay."""
    rng = np.random.default_rng(sum(params) & 0xFFFF)
    assert cuda_score.k1_form(7, *params) == "s16x2"
    planted = "ACGTTGA"
    refs = ["C" + planted + "".join(_seqs(rng, [30])), "".join(_seqs(rng, [40]))]
    reads = [planted] + _seqs(rng, rng.integers(1, 8, 5)) + [""]
    reads_t, refs_t = _grid(reads, refs, 7)
    want = _jax(reads_t, refs_t, params)
    assert want[0, 0] == 32767
    np.testing.assert_array_equal(score_grid(reads_t, refs_t, *params).numpy(), want)
    for lanes, cols in ((32, 16), (4, 4)):
        np.testing.assert_array_equal(_row_s16x2_model(reads_t, refs_t, *params, lanes=lanes, cols=cols).numpy(), want)
        assert _row_s16x2_model(reads_t, refs_t, *params, lanes=lanes, cols=cols, ramp=True)[0, 0] != want[0, 0]


def test_segments_hold_an_alignment_across_a_border():
    """An optimal alignment with 39 reference gap columns (a 16 bp read of
    A, C and G in two halves in a ref of Ts; 80 - 39 = 41 beats either
    half's 40) starting at the last column of segment 0's own stride: only
    segment 0's overlap of W - 1 holds it, and the max over the planned
    segments equals the unsplit grid and the JAX recurrence.  One column
    less of overlap loses it."""
    rng = np.random.default_rng(8)
    params = (5, -3, -1)
    read = "".join(_seqs(rng, [16], np.array(list("ACG"))))
    m, n = 16, 2000
    stride, length = cuda_score.row_segments(m, n, *params, blocks=1, sms=8)
    w = m + params[0] * m // -params[2]
    assert stride < n and length == stride + w - 1 and stride >= 4 * w
    span = 16 + 39
    ref = list("T" * n)
    ref[stride - 1 : stride - 1 + span] = read[:8] + "T" * 39 + read[8:]
    reads_t, refs_t = _grid([read, read[:8]], ["".join(ref)], m)
    want = _jax(reads_t, refs_t, params)
    assert want[0, 0] == 41 and want[1, 0] == 40
    np.testing.assert_array_equal(score_grid(reads_t, refs_t, *params).numpy(), want)
    np.testing.assert_array_equal(_split_best(reads_t, refs_t, params, stride, length).numpy(), want)
    short = _split_best(reads_t, refs_t, params, stride, stride + span - 2)
    assert short[0, 0] == 40


def test_segments_of_short_empty_and_long_refs():
    """One 3 kb ref split into segments beside refs shorter than one
    segment, of 0 and 1 bp, against an odd number of reads (an empty one
    among them): every pair equals the unsplit grid and the JAX
    recurrence."""
    rng = np.random.default_rng(9)
    reads = _seqs(rng, rng.integers(1, 21, 6)) + [""]
    refs = _seqs(rng, [3000, 0, 1, 50, 300])
    reads_t, refs_t = _grid(reads, refs, 20)
    stride, length = cuda_score.row_segments(20, refs_t.shape[1], *PARAMS, blocks=1, sms=16)
    assert 50 < stride < 300 < refs_t.shape[1] and -(-refs_t.shape[1] // stride) > 8
    want = _jax(reads_t, refs_t, PARAMS)
    np.testing.assert_array_equal(_split_best(reads_t, refs_t, PARAMS, stride, length).numpy(), want)
    np.testing.assert_array_equal(score_grid(reads_t, refs_t, *PARAMS).numpy(), want)
    assert not want[:, 1].any() and not want[-1].any()


def test_segments_fall_back_to_one_where_the_plan_cannot_split():
    """One segment (n, n) wherever the bound does not hold or a split buys
    nothing: a positive mismatch, a zero gap, a zero match, reads wider
    than one pass, a launch that already fills the card, references
    shorter than two segments of 4 W, and empty shapes."""
    n = 100_000
    assert cuda_score.row_segments(150, n, *PARAMS, blocks=2, sms=132)[0] < n  # the split itself
    for m, params, blocks, sms, width in (
        (150, (5, 1, -4), 2, 132, n),
        (150, (5, -3, 0), 2, 132, n),
        (150, (0, -3, -4), 2, 132, n),
        (1025, PARAMS, 2, 132, n),
        (150, PARAMS, 264, 132, n),
        (150, PARAMS, 2, 132, 8 * (150 + 5 * 150 // 4) - 1),
        (0, PARAMS, 2, 132, n),
        (150, PARAMS, 2, 132, 0),
    ):
        assert cuda_score.row_segments(m, width, *params, blocks, sms) == (width, width), (m, params, blocks, width)


def test_no_public_function_takes_a_form():
    """K5's form and its split follow from the data alone:
    ``score_grid_row`` keeps its signature, and ``K5_FORMS`` counts both
    forms."""
    for name, fn in inspect.getmembers(cuda_score, inspect.isfunction):
        if fn.__module__ == cuda_score.__name__ and not name.startswith("_"):
            assert "form" not in inspect.signature(fn).parameters, name
    assert list(inspect.signature(cuda_score.score_grid_row).parameters) == [
        "reads_u8", "refs_u8", "match", "mismatch", "gap",
    ]
    cuda_score.reset_launches()
    assert cuda_score.K5_FORMS == {"s16x2": 0, "int32": 0}
    with pytest.raises(ValueError):
        cuda_score._score_grid_row(*_grid(["ACGT"], ["ACGT"]), *PARAMS, form="int8")
