"""The kernels: CUDA for tensors on the card, plain PyTorch on CPU.

Twelve kernels, each with its plain PyTorch version of the same function:

- K1 :func:`lane_best_packed_varlen` (``csrc/lane_best.cu``) replaces
  ``pallas_score.py:_diag_kernel_packed_varlen`` and
  ``pallas_score.py:_chunked_kernel_packed_multi``; through
  :func:`lane_best_packed` (one length, the ``mode=`` options) also
  ``_diag_kernel_packed``, ``_chunked_kernel_packed``,
  ``_stream_kernel_packed`` and ``_diag_kernel_packed_carry``;
- K2 :func:`argmax_lane` (``csrc/argmax.cu``) replaces
  ``pallas_score.py:_chunked_argmax_kernel``; its s16x2 form's column
  segments merge by a second kernel (plain version
  :func:`argmax_merge_plain`);
- K3 :func:`band_lane_best` (``csrc/band.cu``) replaces
  ``pallas_score.py:_diag_kernel_packed_band``; its two forms by its own
  rule (:func:`k3_form`), its segments cut into column pieces
  (:func:`band_segments`);
- K4 :func:`score_grid_diag` (``csrc/score_grid.cu``) replaces
  ``pallas_score.py:_diag_kernel``, ``_chunked_kernel`` and
  ``_diag_kernel_carry``;
- K5 :func:`score_grid_row` (``csrc/score_row.cu``) replaces
  ``pallas_score.py:_score_kernel``; its plain version is the row-form
  recurrence :func:`..ops.recurrence.score_grid`;
- K6 :func:`step_chain_best` (``csrc/step_chain.cu``) replaces
  ``ops/microbench.py:_roofline_kernel`` and, with ``masked=True``,
  ``experiments/triangle_timepack.py:_chain_kernel``;
- K7 :func:`step_variant_best` (``csrc/step_variants.cu``) replaces
  ``experiments/packed_step_variants.py:make_kernel``;
- K8 :func:`max_cells_row` (``csrc/max_cells.cu``) replaces lax code, not
  Pallas: ``sparksmithwaterman_tpu/ops/longseq.py:_max_cells_device_batch``,
  the traceback's listing of every cell equal to a tied read's best; its
  plain version is that row loop and :func:`argwhere_rows`, and a second
  kernel finishes the listing (plain version :func:`max_cells_finish_plain`);
- K9 :func:`fill_dirs` (``csrc/fill_dirs.cu``) replaces lax code:
  ``sparksmithwaterman_tpu/ops/recurrence.py:fill_pairs``, the traceback's
  fill with direction codes; its plain version is
  :func:`..ops.recurrence.fill_pairs`;
- K10 :func:`trace_walk` (``csrc/trace_walk.cu``) replaces lax code:
  ``sparksmithwaterman_tpu/ops/device_traceback.py:_trace_one``, the walk
  from each max cell; its plain version is :func:`trace_walk_plain`;
- K9 and K10 in one launch (``csrc/fill_walk.cu``), on the traceback's
  main path: :func:`fill_list` fills each pair, lists its max cells and
  walks from them (the full-fill branch; plain version
  :func:`fill_list_plain`: K9's, :func:`argwhere_rows` and K10's), and
  :func:`fill_walk` fills each window and walks from its one known max
  cell (the windowed branch; plain version :func:`fill_walk_plain`).
  Neither writes H or a plane of codes: a pair's 2-bit codes stay in
  shared memory where the launch's blocks all find room, else in a
  scratch the same block walks (:func:`fill_route`), and a pair's columns
  spread over the warps of its block (:func:`fill_plan`).

A wrapper takes the plain version only for tensors on the CPU.  For CUDA
tensors it launches the kernel or raises; it never falls back.  Each
launch goes through :func:`_launch`, adds one to :data:`LAUNCHES`, so a
run can show that its main path went through the kernels, and is
recorded by ``utils.profiling`` while that traces.

K1, K2, K4, K5 and K8 have two forms each, and the data alone picks one,
by one rule (:func:`k1_form`): rows (reads) of at most ONE_PASS_LANES
lanes whose scores provably fit int16 run two rows per warp in the 16-bit
halves of each register, the recurrence in DPX instructions ("s16x2");
every other row runs the int32 kernels, one pass or striped ("int32").
K1, K2 and K4 widen it to rows past ONE_PASS_LANES (:func:`k1k4_form`):
a striped row whose longest segment scores fit int16 runs its pair of
rows in stripes, the carry between stripes in 16-bit halves.  K5, whose
row form has no stripes, takes the rule without its lane limit
(:func:`k5_form`); K8 keeps :func:`k1_form`, its wide rows int32.
:data:`K1_FORMS`, :data:`K2_FORMS`, :data:`K4_FORMS`, :data:`K5_FORMS`
and :data:`K8_FORMS` count the launches of each.  K3, whose left column
adds to every cell, and K6 and K7, whose circular shift lets a value grow
past a row's lanes, take the same two forms by their own rules
(:func:`k3_form`, :func:`step_form`; :data:`K3_FORMS`, :data:`K6_FORMS`,
:data:`K7_FORMS`).  A K2 (s16x2), K3, K5 or K8 launch with too few blocks
for the card cuts each reference (K3: each segment) into overlapping
column segments, one block each (:func:`row_segments`; K8 lists each
column in one segment only, :func:`owned_columns`; K2 counts each
diagonal in one segment only, :func:`argmax_segments`; K3's pieces look
back W - 1 columns, :func:`band_segments`).

K1-K5 take rows (reads) of any width.  Up to :data:`ONE_PASS_LANES`
lanes a warp sweeps a row in one pass; a wider row runs in stripes of
:data:`STRIPE_LANES` lanes (:data:`STRIPE16_LANES` in K1's and K4's s16x2
form), top to bottom, each stripe's last lane handed
to the next through carry rows in a scratch buffer that the wrapper
allocates (:func:`carry_elems`; K5 carries one column per read, per pair
of reads in its s16x2 form).  The
scratch of one launch is held to :data:`CARRY_BUDGET`: a launch whose rows
need more runs as several launches of whole blocks of rows, one after
another on the stream, that share one scratch (:func:`carry_rows`).  The
striped sweep reads columns right of a reference as 0 between stripes,
which leaves every lane a caller reads unchanged when mismatch < 0 and
gap < 0 (``ScoringScheme`` admits no other scheme), so K1-K4 take wide
rows only then.  K1 and K3 size their scratch from the references'
lengths, which sit on the card: a caller that has their sum on the host
passes it as ``carry_cols``, else the wrapper reads it (one host sync).

The recurrence (``pallas_score.py:_make_step``), on anti-diagonals d with
lane i holding read position i and column j = d - i:

    D_d[i] = max(0, D_{d-2}[i-1] + sub(read[i], ref[d-i]),
                    max(D_{d-1}[i-1], D_{d-1}[i]) + gap)

with both shifted terms zero at lane 0 (and, packed, at segment starts).
``ref[j]`` reads as REF_PAD outside ``[0, len)`` and READ_PAD matches
nothing.
"""

from __future__ import annotations

import ctypes

import torch

from sparksmithwaterman_tpu_torch.io.fasta import REF_PAD
from sparksmithwaterman_tpu_torch.ops import _cuda
from sparksmithwaterman_tpu_torch.ops.packing import START_BIT
from sparksmithwaterman_tpu_torch.ops.recurrence import (
    DIR_ALIGN, DIR_DEL, DIR_INS, _ramp, _row_update, _sub_scores, fill_pairs, score_grid,
)
from sparksmithwaterman_tpu_torch.utils import profiling

# Launches per kernel since the last reset_launches().
LAUNCHES = {
    "lane_best_packed_varlen": 0,
    "argmax_lane": 0,
    "band_lane_best": 0,
    "score_grid_diag": 0,
    "score_grid_row": 0,
    "step_chain_best": 0,
    "step_variant_best": 0,
    "max_cells_row": 0,
    "fill_dirs": 0,
    "trace_walk": 0,
    "fill_list": 0,
    "fill_walk": 0,
}

# K1's, K2's, K4's, K5's and K8's launches per form (k1_form, k1k4_form, k5_form) since the last reset_launches().
K1_FORMS = {"s16x2": 0, "int32": 0}
K2_FORMS = {"s16x2": 0, "int32": 0}
K4_FORMS = {"s16x2": 0, "int32": 0}
K5_FORMS = {"s16x2": 0, "int32": 0}
K8_FORMS = {"s16x2": 0, "int32": 0}
# K3's launches per form (k3_form) since the last reset_launches().
K3_FORMS = {"s16x2": 0, "int32": 0}
# K6's and K7's launches per form (step_form) since the last reset_launches().
K6_FORMS = {"s16x2": 0, "int32": 0}
K7_FORMS = {"s16x2": 0, "int32": 0}

# Widest row a warp sweeps in one pass (32 threads x 32 lanes); wider
# rows run in stripes of STRIPE_LANES, or STRIPE16_LANES in K1's and K4's
# s16x2 form (csrc/wavefront.cuh kMaxLanes, kStripe, kStripe16L).
ONE_PASS_LANES = 1024
STRIPE_LANES = 512
STRIPE16_LANES = 256
# int32 elements of carry scratch one launch of K1-K5 allocates at most
# (while a block of rows against one launch's references fits).
CARRY_BUDGET = 1 << 28
# Lanes per thread of the csrc/wavefront.cuh kernels (pick_lanes).
_LANES_PER_THREAD = (1, 2, 3, 4, 5, 6, 8, 10, 12, 16, 24, 32)
# Rows (warps) per thread block of K1-K5 (csrc/wavefront.cuh kWarps).
_BLOCK_ROWS = 4
# Carry rows a block of K2's striped s16x2 kernel holds: one for the
# stripe each of its warps sweeps and one for the stripe above them
# (csrc/argmax.cu argmax_wide_s16x2_kernel; its entry refuses less).
_K2_CARRY_ROWS = _BLOCK_ROWS + 1
# Slots of one read that K8's finish sorts in shared memory
# (csrc/max_cells.cu kFinishKeys); more go through a scratch of 64-bit keys.
_FINISH_KEYS = 4096
# Columns of one tile of K9 (csrc/fill_dirs.cu kTileCols): a fill of more
# carries a column of M int32 per pair between tiles.
_FILL_TILE = 512
# The plain walk checks for completion every this many steps (one host sync).
_DONE_CHECK = 32
# Columns per lane of the fill's tiles in fill_list and fill_walk
# (csrc/fill_walk.cu kCols), narrowest first; warps a pair at most
# (kMaxFillWarps); the warps a launch puts on each SM at most, and the
# fewest at which the plan takes its widest tiles (fill_plan).
_FILL_COLS = (4, 8, 16)
_FILL_MAX_WARPS = 16
_FILL_WARPS_PER_SM = 8
_FILL_MIN_WARPS_PER_SM = 2
# Bytes of 2-bit codes a pair keeps in shared memory at most (route
# "shared", fill_route).
_FILL_SMEM_CODES = 160 * 1024
# Listed keys of one pair that fill_list sorts in shared memory
# (csrc/fill_walk.cu kSortKeys); more go through a scratch.
_FILL_SORT_KEYS = 4096


def reset_launches() -> None:
    for counts in (LAUNCHES, K1_FORMS, K2_FORMS, K3_FORMS, K4_FORMS, K5_FORMS, K8_FORMS, K6_FORMS, K7_FORMS):
        for key in counts:
            counts[key] = 0


def _device_of(*tensors: torch.Tensor) -> torch.device:
    device = tensors[0].device
    for t in tensors[1:]:
        if t.device != device:
            raise ValueError(f"tensors on different devices: {device} and {t.device}")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device}")
    return device


def _launch_target(device: torch.device):
    """(device index, current stream handle) for a C entry point."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    return index, torch.cuda.current_stream(device).cuda_stream


def _launch(what: str, entry: str, *args, count: bool = True) -> None:
    """Call the library's C entry ``entry`` with ``args`` (the last two the
    device index and the stream, :func:`_launch_target`), raise on a CUDA
    error as ``what``, and with ``count`` add one to ``LAUNCHES[what]``.
    While ``utils.profiling`` traces, the call is recorded there.  The
    entry is looked up on the library at each call."""
    fn = getattr(_cuda.lib(), entry)
    if profiling.tracing():
        with profiling.TRACER.launch(entry, args[-2], args[-1]):
            rc = fn(*args)
    else:
        rc = fn(*args)
    _cuda.check(rc, what)
    if count:
        LAUNCHES[what] += 1


def carry_elems(m: int, rows: int, cols: int, *, row_form: bool = False, pair: bool = False) -> int:
    """int32 scratch that one reference of ``cols`` columns (or several of
    ``cols`` in all, in K1-K4) costs a launch of ``rows`` rows (reads) of
    ``m`` lanes, rows rounded up to the kernels' blocks of four: none up
    to ONE_PASS_LANES; two carry rows of ``cols`` per row in K1-K4; one
    carried column of ``m`` per read in K5 (``row_form``).  ``pair``: the
    s16x2 forms of K1 and K4, two carry rows of ``cols`` 32-bit words (both
    rows' 16-bit halves) per pair of rows, and of K5, one carried column of
    ``m`` words per pair of reads, rows rounded up to their blocks of
    eight; never more than the int32 form's, which the backends' chunk
    plans keep as an upper bound."""
    if m <= ONE_PASS_LANES:
        return 0
    block = 2 * _BLOCK_ROWS if pair else _BLOCK_ROWS
    rows = -(-rows // block) * block
    if row_form:
        return (rows // 2 if pair else rows) * m
    return rows * cols if pair else 2 * rows * cols


def carry_rows(rows: int, elems: int, *, pair: bool = False) -> int:
    """Rows (reads) per launch of a striped kernel whose carry scratch for
    all ``rows`` rows is ``elems`` int32 (:func:`carry_elems`): all of
    them, rounded up to a block of four (``pair``: eight), when that fits
    CARRY_BUDGET; else as many whole blocks as fit, and at least one
    block, so that a launch takes more only when one block does (in
    K1-K4, references of more than CARRY_BUDGET / 8 = 33.5 M columns in
    all)."""
    block = 2 * _BLOCK_ROWS if pair else _BLOCK_ROWS
    blocks = -(-rows // block)
    fit = CARRY_BUDGET // max(1, elems // max(1, blocks))
    return block * max(1, min(blocks, fit))


def _check_form(what: str, forms: dict, form, rule: str) -> str:
    """The form a kernel with two forms runs: ``form``, or its rule's
    (:func:`k1_form`, :func:`step_form`) when None; raises for a form the
    kernel lacks, or ``"s16x2"`` where the rule says ``"int32"``."""
    form = rule if form is None else form
    if form not in forms or (form == "s16x2" and rule != "s16x2"):
        raise ValueError(f"{what} cannot take form {form!r} where its rule gives {rule!r}")
    return form


def _check_stripes(what: str, m: int, mismatch: int, gap: int) -> None:
    if m > ONE_PASS_LANES and (mismatch >= 0 or gap >= 0):
        raise ValueError(
            f"{what}: rows of more than {ONE_PASS_LANES} lanes run in stripes, which need mismatch < 0 "
            f"and gap < 0 (got {mismatch}, {gap})"
        )


def _carry_rows(m: int, rows: int, cols: torch.Tensor, total, *, pair: bool = False, stride: int = 0,
                back: int = 0):
    """(scratch, (C,) int64 offsets, rows per launch) of K1's or K3's
    carry rows for references of ``cols`` ((C,) tensor) columns, at most
    ``total`` of them in all (read from the card when None); (None, None,
    0) for rows of at most ONE_PASS_LANES lanes.  ``pair``: the s16x2
    forms (:func:`carry_elems`).  ``stride``, ``back``: K3's column pieces
    (:func:`band_segments`), each with carry rows of its own width, so a
    reference cut into k pieces costs (k - 1) x back columns more."""
    if m <= ONE_PASS_LANES:
        return None, None, 0
    cols = cols.to(torch.int64)
    if total is None:
        total = int(cols.sum())
    if stride:
        cols = cols + ((cols + stride - 1) // stride - 1) * back
        total += back * (total // stride)
    part = carry_rows(rows, carry_elems(m, rows, total, pair=pair), pair=pair)
    per = carry_elems(m, part, 1, pair=pair)
    offs = (torch.cumsum(cols, 0) - cols) * per
    return torch.empty(max(1, per * total), dtype=torch.int32, device=cols.device), offs, part


def _ptr(t) -> int | None:
    return None if t is None else t.data_ptr()


def _shift_lanes_right(x: torch.Tensor) -> torch.Tensor:
    """x[..., i-1] at lane i, zero at lane 0."""
    return torch.nn.functional.pad(x[..., :-1], (1, 0))


def _ref_window(refs_i: torch.Tensor, lens: torch.Tensor, d: int, m: int):
    """(C, M) reference code seen by each lane on diagonal d."""
    j = d - torch.arange(m, device=refs_i.device)
    valid = (j >= 0)[None, :] & (j[None, :] < lens[:, None])
    if refs_i.shape[1] == 0:
        return torch.full(valid.shape, REF_PAD, dtype=torch.int32, device=refs_i.device)
    col = refs_i[:, j.clamp(0, refs_i.shape[1] - 1)]
    return torch.where(valid, col, REF_PAD)


# -- K1: packed lane best ------------------------------------------------------

_INT16_MIN, _INT16_MAX = -(1 << 15), (1 << 15) - 1


def k1_form(m: int, match: int, mismatch: int, gap: int) -> str:
    """The form K1 takes for packed rows of ``m`` lanes under a scheme, and
    K4 for unpacked reads of width ``m`` (each read a row of one segment):
    ``"s16x2"`` (two rows per warp, one in each 16-bit half of every
    register, the recurrence in DPX instructions) when every score and
    every intermediate provably fits int16, else ``"int32"``.

    A cell is the best score of a path ending there.  With mismatch <= 0
    and gap <= 0 a path gains at most ``match`` per lane of its segment,
    and a segment is at most m lanes, so 0 <= H <= match * m; every
    negative intermediate (U + mismatch, max(N, W) + gap, with U, N, W >=
    0) is at least min(mismatch, gap).  So the rule is match * m <= 32767,
    -32768 <= mismatch, gap <= 0 <= match, and m <= ONE_PASS_LANES (wider
    rows run in stripes, in int32).  ``ScoringScheme`` (match > 0,
    mismatch and gap < 0) meets the signs.
    """
    return "s16x2" if _fits_int16(m, match, mismatch, gap) and m <= ONE_PASS_LANES else "int32"


def _fits_int16(lanes: int, match: int, mismatch: int, gap: int) -> bool:
    return 0 <= match and match * lanes <= _INT16_MAX and _INT16_MIN <= min(mismatch, gap) and max(mismatch, gap) <= 0


def k5_form(m: int, match: int, mismatch: int, gap: int) -> str:
    """The form K5 (the row form, unpacked reads of width ``m``) takes:
    :func:`k1_form`'s up to ONE_PASS_LANES, and past it ``"s16x2"`` (two
    reads a warp in 16-bit halves, the carried column in both halves)
    wherever the scores fit int16, else ``"int32"``.

    The row form has no stripes: a warp scans whole DP rows, tile by tile,
    one carried column between tiles.  A cell of row i is at most match x
    (i + 1) <= match x m however many columns the row has, and the scan's
    constants across the warp (``ScanGaps``, ``csrc/row_scan.cuh``) are
    clamped at -32,768 whatever m is.  So :func:`k1_form`'s bound holds at
    any width, and K5 takes it without its lane limit: match x m <= 32767,
    -32768 <= mismatch, gap <= 0 <= match (under the default scheme (5,
    -3, -4), reads of up to 6,553 positions).
    """
    return "s16x2" if _fits_int16(m, match, mismatch, gap) else "int32"


def k1k4_form(m: int, match: int, mismatch: int, gap: int, *, longest: int | None = None) -> str:
    """The form K1 (packed rows of ``m`` lanes) and K4 (unpacked reads of
    width ``m``) take: :func:`k1_form`'s up to ONE_PASS_LANES; a wider row,
    which runs in stripes, takes ``"s16x2"`` (two rows a warp in 16-bit
    halves, the stripe carry in both halves) where its scores fit int16
    and mismatch < 0 and gap < 0 (the stripes' rule), else ``"int32"``.

    The bound of :func:`k1_form` holds a segment at a time: a cell is at
    most ``match`` x the lanes of its segment up to it.  So a wide row
    fits where match x its longest segment <= 32767.  ``longest`` (K1: the
    longest read of the pack, which the caller holds on the host) bounds
    the segment; without it the row's width does.  Rows are power-of-two
    wide, so a read of 4,097-6,553 bp sits in an 8,192-lane row that the
    width alone would put in int32 at match 5.  For K4 ``m`` is the read
    group's width, already its longest read.
    """
    if m <= ONE_PASS_LANES:
        return k1_form(m, match, mismatch, gap)
    fits = _fits_int16(_segment_lanes(m, longest), match, mismatch, gap) and mismatch < 0 and gap < 0
    return "s16x2" if fits else "int32"


def _segment_lanes(m: int, longest) -> int:
    """The lanes of a row's longest segment (read) that the wide forms'
    rules take: ``m`` for rows of one pass or without ``longest``, else
    min(m, longest)."""
    return m if m <= ONE_PASS_LANES or longest is None else min(m, max(1, int(longest)))


def segmented_suffix_max(x: torch.Tensor, start: torch.Tensor) -> torch.Tensor:
    """Lane i becomes max(x[..., i .. end of its segment)); segments begin
    at lanes where ``start`` (broadcastable to x) is true.  Log doubling
    with a blocked mask, as ``pallas_score._segmented_suffix_max``."""
    m = x.shape[-1]

    def shift_left(v, s, fill):
        return torch.nn.functional.pad(v[..., s:], (0, s), value=fill)

    blocked = shift_left(start.to(torch.int32), 1, 1).expand_as(x)
    s = 1
    while s < m:
        x = torch.where(blocked > 0, x, torch.maximum(x, shift_left(x, s, 0)))
        if 2 * s < m:
            blocked = blocked | shift_left(blocked, s, 1)
        s *= 2
    return x


def _clamped_lens(lens: torch.Tensor, n: int) -> torch.Tensor:
    return lens.to(torch.int64).clamp(0, n)


def _padded_refs(flat: torch.Tensor, lens: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
    """(C, max len) uint8 view of a flat reference buffer, REF_PAD-padded."""
    n = int(lens.max()) if lens.numel() else 0
    j = torch.arange(n, device=flat.device)
    idx = (offsets.to(torch.int64)[:, None] + j).clamp(0, max(flat.numel() - 1, 0))
    return torch.where(j < lens.to(torch.int64)[:, None], flat[idx], REF_PAD).to(torch.uint8)


def lane_best_packed_varlen_plain(packed, refs_u8, lens, match, mismatch, gap, offsets=None):
    """Plain PyTorch version of K1 (any device): the diagonal loop on a
    (C, ROWS, M) state.  Reference c runs exactly m + len_c - 1 diagonals
    (none when len_c == 0); lens are clamped to [0, N]."""
    if offsets is not None:
        refs_u8 = _padded_refs(refs_u8, lens, offsets)
    rows, m = packed.shape
    c, n = refs_u8.shape
    device = packed.device
    read = (packed & (START_BIT - 1)).to(torch.int32)
    start = packed >= START_BIT
    zero = start.clone()
    zero[:, 0] = True
    lens = _clamped_lens(lens, n)
    nd = torch.where(lens > 0, m + lens - 1, 0)
    refs_i = refs_u8.to(torch.int32)
    shape = (c, rows, m)
    d1 = torch.zeros(shape, dtype=torch.int32, device=device)
    r1 = torch.zeros_like(d1)
    r2 = torch.zeros_like(d1)
    best = torch.zeros_like(d1)
    for d in range(int(nd.max()) if c else 0):
        refwin = _ref_window(refs_i, lens, d, m)[:, None, :]
        sub = torch.where(read[None] == refwin, match, mismatch).to(torch.int32)
        c1 = torch.clamp_min(torch.maximum(r2 + sub, torch.maximum(r1, d1) + gap), 0)
        active = (d < nd)[:, None, None]
        best = torch.where(active, torch.maximum(best, c1), best)
        rc = _shift_lanes_right(c1).masked_fill_(zero, 0)
        d1, r2, r1 = c1, r1, rc
    return segmented_suffix_max(best, start)


def lane_best_packed_varlen(packed, refs_u8, lens, match, mismatch, gap, offsets=None, *, carry_cols=None,
                            longest=None):
    """(C, ROWS, M) int32 per-lane best of packed read rows against
    mixed-length references.

    packed: (ROWS, M) int32, read code | START_BIT on segment starts
    (``ops.packing.pack_reads``); lens: (C,) int32 true lengths.  The
    references are either refs_u8 (C, N) uint8, REF_PAD-padded (lens
    clamped to [0, N]), or, with ``offsets`` (C,) int64, one flat uint8
    buffer refs_u8 holding reference c at ``offsets[c] : offsets[c] +
    lens[c]`` (every range inside the buffer).

    Contract: each segment's START lane holds that read's best score
    against the reference.  Read only start lanes (``packing.read_best``,
    ``packing.packed_col_sums``); other lanes are not part of the
    contract and differ from the TPU kernel, which sweeps padding too.

    ``carry_cols``: at least the sum of the lengths (each clamped to
    [0, N]), given when the caller has it on the host, so that a launch
    of rows wider than ONE_PASS_LANES sizes its carry scratch without a
    host sync.

    ``longest``: at least the lanes of the longest segment of ``packed``
    (the longest read packed in it), given when the caller has it on the
    host; a row wider than ONE_PASS_LANES then takes the 16-bit form
    where match x longest fits int16, where its width alone may not.  A
    value under the true longest segment is outside the contract.

    K1's form follows from ``m``, ``longest`` and the scheme alone
    (:func:`k1k4_form`).
    """
    return _lane_best_packed_varlen(packed, refs_u8, lens, match, mismatch, gap, offsets, carry_cols=carry_cols,
                                    longest=longest)


def _lane_best_packed_varlen(packed, refs_u8, lens, match, mismatch, gap, offsets=None, *, carry_cols=None,
                             longest=None, form=None):
    """:func:`lane_best_packed_varlen` with K1's form given (``form=None``:
    :func:`k1k4_form`'s), so that the two forms can be timed on the same
    inputs; ``"s16x2"`` where k1k4_form says ``"int32"`` raises."""
    device = _device_of(packed, refs_u8, lens, *(() if offsets is None else (offsets,)))
    if packed.dim() != 2 or packed.dtype != torch.int32:
        raise ValueError("packed must be a (ROWS, M) int32 tensor")
    if refs_u8.dtype != torch.uint8 or refs_u8.dim() != (2 if offsets is None else 1):
        raise ValueError("refs_u8 must be a (C, N) uint8 tensor, or a 1-D uint8 buffer with offsets")
    c = refs_u8.shape[0] if offsets is None else offsets.shape[0]
    if offsets is not None and (offsets.shape != (c,) or offsets.dtype != torch.int64):
        raise ValueError("offsets must be a (C,) int64 tensor")
    if lens.shape != (c,) or lens.dtype != torch.int32:
        raise ValueError("lens must be a (C,) int32 tensor")
    match, mismatch, gap = int(match), int(mismatch), int(gap)
    rows, m = packed.shape
    seg = m if longest is None else min(m, max(1, int(longest)))
    form = _check_form("K1", K1_FORMS, form, k1k4_form(m, match, mismatch, gap, longest=seg))
    if device.type == "cpu":
        return lane_best_packed_varlen_plain(packed, refs_u8, lens, match, mismatch, gap, offsets)
    _check_stripes("lane_best_packed_varlen", m, mismatch, gap)
    out = torch.empty((c, rows, m), dtype=torch.int32, device=device)
    if c == 0 or rows == 0:
        return out
    if offsets is None:
        n = refs_u8.shape[1]
        lens = _clamped_lens(lens, n).to(torch.int32)
        offsets = torch.arange(c, dtype=torch.int64, device=device) * n
        carry_cols = c * n if carry_cols is None else carry_cols
    packed = packed.contiguous()
    refs_u8 = refs_u8.contiguous()
    lens = lens.contiguous()
    offsets = offsets.contiguous()
    carry, carry_offs, part = None, None, 0
    if m > ONE_PASS_LANES:
        carry, carry_offs, part = _carry_rows(m, rows, lens.clamp_min(0), carry_cols, pair=form == "s16x2")
    if form == "s16x2":
        _launch(
            "lane_best_packed_varlen", "swt_lane_best_varlen_s16x2",
            packed.data_ptr(), rows, m,
            refs_u8.data_ptr(), offsets.data_ptr(), lens.data_ptr(), c,
            match, mismatch, gap, out.data_ptr(), _ptr(carry), _ptr(carry_offs), part, seg,
            *_launch_target(device),
        )
    else:
        _launch(
            "lane_best_packed_varlen", "swt_lane_best_varlen",
            packed.data_ptr(), rows, m,
            refs_u8.data_ptr(), offsets.data_ptr(), lens.data_ptr(), c,
            match, mismatch, gap,
            out.data_ptr(), _ptr(carry), _ptr(carry_offs), part, *_launch_target(device),
        )
    K1_FORMS[form] += 1
    return out


# -- K2: per-lane argmax ---------------------------------------------------------


def _unpacked_diagonals(reads_u8, refs_u8, match, mismatch, gap):
    """Yield (d, cells): the (R, C, M) cells of anti-diagonal d of every
    (read, ref) pair, d = 0 .. m + n - 2 (none when n == 0)."""
    r, m = reads_u8.shape
    c, n = refs_u8.shape
    device = reads_u8.device
    reads_i = reads_u8.to(torch.int32)[:, None, :]
    refs_i = refs_u8.to(torch.int32)
    lens = torch.full((c,), n, dtype=torch.int64, device=device)
    d1 = torch.zeros((r, c, m), dtype=torch.int32, device=device)
    r1 = torch.zeros_like(d1)
    r2 = torch.zeros_like(d1)
    for d in range(m + n - 1 if n > 0 else 0):
        refwin = _ref_window(refs_i, lens, d, m)[None]
        sub = torch.where(reads_i == refwin, match, mismatch).to(torch.int32)
        c1 = torch.clamp_min(torch.maximum(r2 + sub, torch.maximum(r1, d1) + gap), 0)
        yield d, c1
        d1, r2, r1 = c1, r1, _shift_lanes_right(c1)


def argmax_lane_plain(reads_u8, refs_u8, match, mismatch, gap):
    """Plain PyTorch version of K2 (any device): the diagonal loop on an
    (R, C, M) state, exactly m + n - 1 diagonals."""
    shape = (reads_u8.shape[0], refs_u8.shape[0], reads_u8.shape[1])
    best = torch.zeros(shape, dtype=torch.int32, device=reads_u8.device)
    bestd = torch.zeros_like(best)
    count = torch.zeros_like(best)
    for d, c1 in _unpacked_diagonals(reads_u8, refs_u8, match, mismatch, gap):
        gt = c1 > best
        eq = (c1 == best) & (best > 0)
        best = torch.where(gt, c1, best)
        bestd = torch.where(gt, d, bestd)
        count = torch.where(gt, 1, count + eq.to(torch.int32))
    return best, bestd, count


def argmax_merge_plain(best, bestd, count):
    """Plain PyTorch version of K2's merge of its column segments (any
    device): partials (S, R, C, M) int32 each, in segment order, give per
    lane the max best, the bestd of the lowest segment reaching it and the
    sum of those segments' counts (0 where the best is 0)."""
    top = best.amax(dim=0)
    hit = (best == top) & (top > 0)
    first = hit.to(torch.uint8).argmax(dim=0, keepdim=True)
    bestd = torch.where(top > 0, bestd.gather(0, first)[0], 0)
    return top, bestd.to(torch.int32), torch.where(hit, count, 0).sum(dim=0, dtype=torch.int32)


def argmax_segments(m: int, n: int, match: int, mismatch: int, gap: int, blocks: int, sms: int):
    """(stride, length, offset, count) of K2's column segments for a
    s16x2 launch of ``blocks`` blocks (blocks of eight reads, or of one
    pair of reads wider than ONE_PASS_LANES, x references) on a card of
    ``sms`` SMs: segment s covers the columns [s stride, s
    stride + length) and counts the cells of the global diagonals it owns,
    segment 0 from 0, segment s >= 1 from s stride + offset, up to where
    the next starts and the last to m + n - 1; (n, n, 0, 1) is one segment.

    K5's split (:func:`row_segments`) at _K2_BLOCKS_PER_SM blocks per SM,
    at any width of the reads under the same signs: K2 is a chain of m + n
    - 1 dependent diagonals a warp, so more warps hide more of it.  offset
    = W + m - 2 (W = m + match m // |gap|) puts every owned cell of every
    lane at a local column >= W - 1, where a segment's cells are exact
    (``csrc/argmax.cu``) whatever m is."""
    if not (m > 0 and n > 0 and match > 0 and mismatch <= 0 and gap < 0 and blocks > 0):
        return n, n, 0, 1
    stride = _split_stride(m, n, match, gap, blocks, sms, _K2_BLOCKS_PER_SM)
    if stride >= n:
        return n, n, 0, 1
    offset = m + match * m // -gap + m - 2
    return stride, stride + offset, offset, max(1, -(-(m + n - 1 - offset) // stride))


def _argmax_carry(m: int, r: int, blocks_per_pair: int, length: int, device):
    """(scratch or None, its row length, reads per launch) of K2's s16x2
    form on reads of ``m`` positions: none up to ONE_PASS_LANES; past it
    _K2_CARRY_ROWS carry rows a block, of ``length`` + m uint32 (a segment's columns and those right of the reference that a
    cell can reach), for each of a pair's ``blocks_per_pair`` blocks
    (references x segments), pairs of reads per launch held to
    CARRY_BUDGET (``csrc/argmax.cu``)."""
    if m <= ONE_PASS_LANES:
        return None, 0, 0
    cols = length + m
    per_pair = _K2_CARRY_ROWS * cols * blocks_per_pair
    pairs = max(1, min(-(-r // 2), CARRY_BUDGET // per_pair))
    return torch.empty(pairs * per_pair, dtype=torch.int32, device=device), cols, 2 * pairs


def argmax_lane(reads_u8, refs_u8, match, mismatch, gap):
    """Per-lane (best, first diagonal, tie count), three (R, C, M) int32.

    reads_u8: (R, M) uint8 unpacked reads (READ_PAD-padded); refs_u8:
    (C, N) uint8.  Lane i of pair (r, c) covers DP row i + 1: its max,
    the first anti-diagonal d = i + j reaching it (strict >), and how
    many of the row's cells equal it (counted only while best > 0).

    Contract: exact on lanes whose best equals the read's max — the
    lanes from which ``longseq.find_max_cells_batched`` rebuilds cells
    as (lane, bestd - lane).  Other lanes are not part of the contract.

    K2's form follows from M and the scheme alone (:func:`k1k4_form`, the
    rule of K1 and K4: reads wider than ONE_PASS_LANES in stripes, in the
    16-bit form where they fit it); a s16x2 launch with too few blocks for
    the card cuts each reference into column segments
    (:func:`argmax_segments`), which gives the same lanes.
    """
    return _argmax_lane(reads_u8, refs_u8, match, mismatch, gap)


def _argmax_lane(reads_u8, refs_u8, match, mismatch, gap, *, form=None, split=True):
    """:func:`argmax_lane` with K2's form given (``form=None``:
    :func:`k1k4_form`'s), so that the two forms can be timed on the same
    inputs; ``"s16x2"`` where k1k4_form says ``"int32"`` raises.
    ``split=False`` runs each reference as one segment."""
    device = _check_grid_inputs("argmax_lane", reads_u8, refs_u8)
    match, mismatch, gap = int(match), int(mismatch), int(gap)
    r, m = reads_u8.shape
    c, n = refs_u8.shape
    form = _check_form("K2", K2_FORMS, form, k1k4_form(m, match, mismatch, gap))
    if device.type == "cpu":
        return argmax_lane_plain(reads_u8, refs_u8, match, mismatch, gap)
    _check_stripes("argmax_lane", m, mismatch, gap)
    outs = tuple(
        torch.empty((r, c, m), dtype=torch.int32, device=device) for _ in range(3)
    )
    if r == 0 or c == 0 or m == 0:
        return outs
    if n == 0:
        for o in outs:
            o.zero_()
        return outs
    reads_u8 = reads_u8.contiguous()
    refs_u8 = refs_u8.contiguous()
    if form == "s16x2":
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        reads_per_block = 2 if m > ONE_PASS_LANES else 2 * _BLOCK_ROWS
        plan = argmax_segments(m, n, match, mismatch, gap, -(-r // reads_per_block) * c, sms) if split else (
            n, n, 0, 1)
        segs = plan[3]
        parts = outs if segs == 1 else tuple(
            torch.empty((segs, r, c, m), dtype=torch.int32, device=device) for _ in range(3))
        carry, cols, part = _argmax_carry(m, r, c * segs, min(plan[1], n), device)
        _launch(
            "argmax_lane", "swt_argmax_lane_s16x2",
            reads_u8.data_ptr(), r, m, refs_u8.data_ptr(), n, c, n, match, mismatch, gap,
            *(o.data_ptr() for o in parts), *plan, _ptr(carry), 0 if carry is None else carry.numel(), cols, part,
            *_launch_target(device),
        )
        if segs > 1:
            _launch("argmax_lane (merge)", "swt_argmax_merge", *(o.data_ptr() for o in parts), segs, r * c * m,
                    *(o.data_ptr() for o in outs), *_launch_target(device), count=False)
    else:
        carry, part = _carry_grid(m, r, c, n, False, device)
        _launch(
            "argmax_lane", "swt_argmax_lane",
            reads_u8.data_ptr(), r, m,
            refs_u8.data_ptr(), n, c, n,
            match, mismatch, gap,
            *(o.data_ptr() for o in outs), _ptr(carry), part, *_launch_target(device),
        )
    K2_FORMS[form] += 1
    return outs


# -- K3: packed lane best over one reference segment ------------------------------


def band_lane_best_plain(packed, seg_u8, offsets, seg_lens, ns, bnd, match, mismatch, gap):
    """Plain PyTorch version of K3 (any device): K1's diagonal loop over
    each segment's m + ns - 1 diagonals, with the left column set as the
    state of lane d before diagonal d (and as lane d+1's N term on it)
    and the right column read off diagonal i + ns - 1."""
    rows, m = packed.shape
    c = ns.shape[0]
    device = packed.device
    lens = seg_lens.to(torch.int64).clamp_min(0)
    segs = _padded_refs(seg_u8, lens, offsets).to(torch.int32)
    width = ns.to(torch.int64).clamp_min(1)
    nd = m + width - 1
    read = (packed & (START_BIT - 1)).to(torch.int32)
    start = packed >= START_BIT
    zero = start.clone()
    zero[:, 0] = True
    lane = torch.arange(m, device=device)
    bnd = bnd.to(torch.int32)
    bnd_up = _shift_lanes_right(bnd).masked_fill_(zero, 0)
    shape = (c, rows, m)
    d1 = torch.zeros(shape, dtype=torch.int32, device=device)
    r1 = torch.zeros_like(d1)
    r2 = torch.zeros_like(d1)
    best = torch.zeros_like(d1)
    bnd_out = torch.zeros_like(d1)
    for d in range(int(nd.max()) if c else 0):
        if d < m:
            d1 = torch.where(lane == d, bnd, d1)
            r1 = torch.where(lane == d + 1, bnd_up, r1)
        refwin = _ref_window(segs, lens, d, m)[:, None, :]
        sub = torch.where(read[None] == refwin, match, mismatch).to(torch.int32)
        c1 = torch.clamp_min(torch.maximum(r2 + sub, torch.maximum(r1, d1) + gap), 0)
        best = torch.where((d < nd)[:, None, None], torch.maximum(best, c1), best)
        last = lane[None, :] == d - (width[:, None] - 1)
        bnd_out = torch.where(last[:, None, :], c1, bnd_out)
        rc = _shift_lanes_right(c1).masked_fill_(zero, 0)
        d1, r2, r1 = c1, r1, rc
    return segmented_suffix_max(best, start), bnd_out


def k3_form(m: int, match: int, mismatch: int, gap: int, *, longest: int | None = None) -> str:
    """The form K3 takes for packed rows of ``m`` lanes under a scheme:
    ``"s16x2"`` (K1's 16-bit design, two rows a warp in the halves of
    each register; past ONE_PASS_LANES in stripes) when every value of the
    sweep provably fits int16 for every left column within
    :func:`band_lane_best`'s contract, else ``"int32"``.

    The contract bounds the left column: 0 <= bnd <= match * L, L = m, or
    min(m, ``longest``) past ONE_PASS_LANES when the caller gives the
    longest read of the pack (up to ONE_PASS_LANES ``longest`` is not
    read).  With mismatch <= 0 and gap <= 0 a path gains at most ``match``
    per lane it moves down its read, so a cell of the one DP of a read
    against the reference is at most match x the read's lanes <= match *
    L: every ``bnd_out`` of K3 meets the contract, and so do the zeros of
    a reference's first segment.  Within a read at most L - 1 lanes lie
    below a lane whose left value a path starts from, so every cell of the
    band is at most match * L + match * (L - 1) = match * (2L - 1).  The
    NW term U of a lane is a value of the lane above, at most match * (2L
    - 2), so U + (match - mismatch) <= match * (2L - 1) - mismatch <=
    65,535 and the IMAD carries nothing across halves exactly when match *
    (2L - 1) <= 32,767; every negative intermediate is at least
    min(mismatch, gap).  So the rule is k1_form's with 2L - 1 in place of
    m: match * (2L - 1) <= 32767, -32768 <= mismatch, gap <= 0 <= match,
    and past ONE_PASS_LANES (stripes) mismatch < 0 and gap < 0.  It is
    exact: at match * (2L - 1) = 32,768 or more, bnd = match * L on lane 0
    and a read whose lanes 1 .. L - 1 match the segment's columns 0 .. L -
    2 reach match * (2L - 1) on lane L - 1.  Under (5, -3, -4), 2,048-lane
    rows fit by width alone, 4,096-lane rows only with longest <= 3,277.
    """
    lanes = _segment_lanes(m, longest)
    fits = (0 <= match and match * (2 * lanes - 1) <= _INT16_MAX and _INT16_MIN <= min(mismatch, gap)
            and max(mismatch, gap) <= 0)
    if m > ONE_PASS_LANES:
        fits = fits and mismatch < 0 and gap < 0
    return "s16x2" if fits else "int32"


# A K3 launch that cuts its segments into pieces aims at this many blocks
# per SM (K3, as K2, is a chain of dependent diagonals a warp; 8 beat 2
# and 4 on one H100, PERF.md PR 16).
_K3_BLOCKS_PER_SM = 8


def _band_splits(m: int, match: int, mismatch: int, gap: int) -> bool:
    return m > 0 and match > 0 and mismatch <= 0 and gap < 0


def band_segments(m: int, cols: int, refs: int, row_blocks: int, match: int, mismatch: int, gap: int, sms: int, *,
                  longest: int | None = None):
    """(stride, back) of the column pieces into which a K3 launch cuts its
    segments: ``refs`` segments of ``cols`` columns in all (each counted
    as at least one), ``row_blocks`` blocks of rows each, on a card of
    ``sms`` SMs.  A segment of n columns becomes ceil(n / stride) pieces,
    piece k >= 1 beginning ``back`` = W - 1 columns before k * stride
    (:func:`band_pieces`); ``(cols, 0)`` is one piece a segment.

    Exact under the signs of :func:`row_segments` (``csrc/band.cu``), for
    rows of any width: an alignment of positive score of a read of at
    most L lanes spans at most W = L + match L // |gap| columns (L = m,
    or min(m, ``longest``) past ONE_PASS_LANES, as :func:`k3_form`), and
    with stride >= _SEGMENT_WINDOWS x W no path from the left column
    (at most match x L) reaches a piece after the first.  Neither bound
    depends on the row being swept in one pass: a wide row's piece sweeps
    its stripes over the piece's columns, its carry rows as wide as the
    piece, so it computes the DP of those columns exactly as one pass
    would.  The stride is the launch's columns over the pieces
    that _K3_BLOCKS_PER_SM blocks per SM need, so a long segment is cut into more
    pieces than a short one and no block sweeps much more than the
    launch's columns per block it keeps running at once; a segment
    shorter than the stride stays whole, and a launch that already has
    _K3_BLOCKS_PER_SM blocks per SM from its rows alone is not cut.
    """
    if not (_band_splits(m, match, mismatch, gap) and cols > 0 and refs > 0 and row_blocks > 0):
        return cols, 0
    lanes = _segment_lanes(m, longest)
    w = lanes + match * lanes // -gap
    pieces = -(-_K3_BLOCKS_PER_SM * sms // row_blocks)
    stride = max(_SEGMENT_WINDOWS * w, -(-cols // pieces))
    return (cols, 0) if stride >= cols else (stride, w - 1)


def band_pieces(n: int, stride: int, back: int):
    """[(j0, j1)] of the columns each piece of one K3 segment of ``n``
    columns (at least 1) sweeps under the plan ``(stride, back)`` of
    :func:`band_segments`, as ``csrc/band.cu`` places its blocks: piece k
    covers [k stride - back, (k + 1) stride) (piece 0 from column 0, the
    last up to n); it owns [k stride, (k + 1) stride)."""
    n = max(int(n), 1)
    count = -(-n // stride)
    return [(k * stride - back if k else 0, (k + 1) * stride if k + 1 < count else n) for k in range(count)]


def band_lane_best(packed, seg_u8, offsets, seg_lens, ns, bnd, match, mismatch, gap, *, carry_cols=None,
                   longest=None):
    """(lane_best, bnd_out), two (C, ROWS, M) int32: packed read rows
    against one segment of each of C references, the DP's left boundary
    column in and its right boundary column out.

    packed: (ROWS, M) int32 as for K1.  Segment c is the ``seg_lens[c]``
    bytes of the flat uint8 buffer ``seg_u8`` at ``offsets[c]`` ((C,)
    int64; (C,) int32 lengths); it has ``ns[c]`` columns ((C,) int32,
    taken as at least 1), those past ``seg_lens[c]`` reading as REF_PAD,
    and runs exactly m + ns[c] - 1 diagonals.  bnd: (C, ROWS, M) int32,
    the column H[i, -1] left of the segment (zero for a reference's first
    segment).  It is a column of the same DP, so 0 <= bnd <= match * M,
    and with ``longest`` (the longest read of the pack, which the caller
    holds on the host) 0 <= bnd <= match * longest: every ``bnd_out`` of
    this function and the zeros of a first segment meet that contract
    (:func:`k3_form`), and the kernel's 16-bit form and its column pieces
    rely on it.

    Defined lanes: ``lane_best`` at each read's START lane (the read's
    best over this segment's cells, as K1's contract); ``bnd_out`` =
    H[i, ns[c] - 1] at every lane i < M.  Chaining segments left to
    right through bnd/bnd_out and taking the max of the start lanes
    equals K1 on the whole reference.  The TPU kernel also sweeps padding
    diagonals, so it agrees with this function at start lanes and at the
    bnd_out lanes of reads, not at the other lanes.

    ``carry_cols``: at least the sum of max(ns, 1), given when the caller
    has it on the host; a launch that may cut its segments into column
    pieces plans them from it, and rows wider than ONE_PASS_LANES size
    their carry scratch from it (else the wrapper reads it: one host
    sync).

    K3's form follows from M, ``longest`` and the scheme alone
    (:func:`k3_form`); a launch with too few blocks for the card cuts
    each long segment into column pieces (:func:`band_segments`), rows of
    any width, which gives the same lanes.
    """
    return _band_lane_best(packed, seg_u8, offsets, seg_lens, ns, bnd, match, mismatch, gap, carry_cols=carry_cols,
                           longest=longest)


def _band_lane_best(packed, seg_u8, offsets, seg_lens, ns, bnd, match, mismatch, gap, *, carry_cols=None,
                    longest=None, form=None, split=True):
    """:func:`band_lane_best` with K3's form given (``form=None``:
    :func:`k3_form`'s), so that the two forms can be timed on the same
    inputs; ``"s16x2"`` where k3_form says ``"int32"`` raises.
    ``split=False`` runs each segment as one piece."""
    device = _device_of(packed, seg_u8, offsets, seg_lens, ns, bnd)
    if packed.dim() != 2 or packed.dtype != torch.int32:
        raise ValueError("packed must be a (ROWS, M) int32 tensor")
    if seg_u8.dim() != 1 or seg_u8.dtype != torch.uint8:
        raise ValueError("seg_u8 must be a 1-D uint8 buffer")
    c = ns.shape[0]
    rows, m = packed.shape
    if ns.shape != (c,) or ns.dtype != torch.int32:
        raise ValueError("ns must be a (C,) int32 tensor")
    if offsets.shape != (c,) or offsets.dtype != torch.int64:
        raise ValueError("offsets must be a (C,) int64 tensor")
    if seg_lens.shape != (c,) or seg_lens.dtype != torch.int32:
        raise ValueError("seg_lens must be a (C,) int32 tensor")
    if bnd.shape != (c, rows, m) or bnd.dtype != torch.int32:
        raise ValueError(f"bnd must be a ({c}, {rows}, {m}) int32 tensor")
    match, mismatch, gap = int(match), int(mismatch), int(gap)
    form = _check_form("K3", K3_FORMS, form, k3_form(m, match, mismatch, gap, longest=longest))
    if device.type == "cpu":
        return band_lane_best_plain(packed, seg_u8, offsets, seg_lens, ns, bnd, match, mismatch, gap)
    _check_stripes("band_lane_best", m, mismatch, gap)
    out = torch.empty((c, rows, m), dtype=torch.int32, device=device)
    bnd_out = torch.empty_like(out)
    if c == 0 or rows == 0 or m == 0:
        return out, bnd_out
    packed, seg_u8, offsets, seg_lens, ns, bnd = (
        t.contiguous() for t in (packed, seg_u8, offsets, seg_lens, ns, bnd)
    )
    cols = ns.clamp_min(1)
    stride, back, cum, pieces = 0, 0, None, c
    if split and _band_splits(m, match, mismatch, gap):
        total = carry_cols = int(cols.sum()) if carry_cols is None else int(carry_cols)
        per_block = 2 * _BLOCK_ROWS if form == "s16x2" else _BLOCK_ROWS
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        stride, back = band_segments(m, total, c, -(-rows // per_block), match, mismatch, gap, sms, longest=longest)
        if stride < total:
            cum = torch.cumsum((cols + (stride - 1)) // stride, 0, dtype=torch.int32)
            pieces = c + total // stride
            out.zero_()  # the pieces take their max into it
        else:
            stride, back = 0, 0
    common = (packed.data_ptr(), rows, m, seg_u8.data_ptr(), offsets.data_ptr(), seg_lens.data_ptr(), ns.data_ptr(),
              c, bnd.data_ptr(), match, mismatch, gap, out.data_ptr(), bnd_out.data_ptr())
    carry, carry_offs, part = _carry_rows(m, rows, cols, carry_cols, pair=form == "s16x2", stride=stride, back=back)
    plan = (_ptr(carry), _ptr(carry_offs), part, stride, back, _ptr(cum), pieces, _segment_lanes(m, longest))
    entry = "swt_band_lane_best_s16x2" if form == "s16x2" else "swt_band_lane_best"
    _launch("band_lane_best", entry, *common, *plan, *_launch_target(device))
    K3_FORMS[form] += 1
    return out, bnd_out


# -- K1 with one length: the TPU kernels' window modes ---------------------------

# The ``mode=`` values of ``pallas_score.pallas_lane_best_packed``.
LANE_BEST_MODES = ("auto", "whole", "chunked", "stream", "carry")


def lane_best_packed(packed, refs_u8, match, mismatch, gap, *, mode="auto"):
    """(C, ROWS, M) int32 per-lane best of packed read rows against C
    references of one padded length: K1 with every length N.

    packed: (ROWS, M) int32 as for :func:`lane_best_packed_varlen`;
    refs_u8: (C, N) uint8, REF_PAD-padded (the padding is swept, as on
    the TPU).  ``mode`` takes the TPU package's values, which chose how
    the reference window was staged in VMEM (whole table, streamed
    chunks, manual double buffering, a carried column); K1 streams every
    reference through its shared ring, so each mode runs the same kernel.
    The contract is K1's: read only start lanes.
    """
    if mode not in LANE_BEST_MODES:
        raise ValueError(f"mode must be one of {LANE_BEST_MODES}, got {mode!r}")
    if refs_u8.dim() != 2:
        raise ValueError("refs_u8 must be a (C, N) uint8 tensor")
    c, n = refs_u8.shape
    lens = torch.full((c,), n, dtype=torch.int32, device=refs_u8.device)
    return lane_best_packed_varlen(packed, refs_u8, lens, match, mismatch, gap)


# -- K4 and K5: best per (read, ref) pair, unpacked reads -------------------------


def _check_grid_inputs(what, reads_u8, refs_u8):
    """The device of an unpacked (reads, refs) pair, after checking both."""
    device = _device_of(reads_u8, refs_u8)
    if reads_u8.dim() != 2 or reads_u8.dtype != torch.uint8:
        raise ValueError(f"{what}: reads_u8 must be an (R, M) uint8 tensor")
    if refs_u8.dim() != 2 or refs_u8.dtype != torch.uint8:
        raise ValueError(f"{what}: refs_u8 must be a (C, N) uint8 tensor")
    return device


def _carry_grid(m, r, c, n, row_form, device, pair=False):
    """(scratch or None, reads per launch) of an unpacked launch (K2, K4,
    K5; ``pair``: K4's and K5's s16x2 forms) of r reads of m positions against c
    references of n columns."""
    elems = c * carry_elems(m, r, n, row_form=row_form, pair=pair)
    if not elems:
        return None, 0
    part = carry_rows(r, elems, pair=pair)
    scratch = torch.empty(c * carry_elems(m, part, n, row_form=row_form, pair=pair), dtype=torch.int32, device=device)
    return scratch, part


def _launch_grid(entry: str, name, forms, form, reads_u8, refs_u8, match, mismatch, gap, segments=()):
    """(R, C) int32 from C entry ``entry`` with K4's arguments, or K5's with
    ``segments`` = (stride, length) of :func:`row_segments`; the launch
    counts in LAUNCHES[name] and in ``forms[form]``."""
    r, m = reads_u8.shape
    c, n = refs_u8.shape
    # Segments take their max into the output with atomicMax.
    split = bool(segments) and segments[0] < n
    out = (torch.zeros if split else torch.empty)((r, c), dtype=torch.int32, device=reads_u8.device)
    if r == 0 or c == 0:
        return out
    if m == 0 or n == 0:
        return out.zero_()
    reads_u8 = reads_u8.contiguous()
    refs_u8 = refs_u8.contiguous()
    carry, part = _carry_grid(m, r, c, n, name == "score_grid_row", reads_u8.device, pair=form == "s16x2")
    _launch(
        name, entry, reads_u8.data_ptr(), r, m, refs_u8.data_ptr(), c, n,
        match, mismatch, gap, out.data_ptr(), _ptr(carry), part, *segments, *_launch_target(reads_u8.device),
    )
    forms[form] += 1
    return out


def score_grid_diag_plain(reads_u8, refs_u8, match, mismatch, gap):
    """Plain PyTorch version of K4 (any device): the diagonal loop on an
    (R, C, M) state over all m + n - 1 diagonals, then the max over
    lanes."""
    r, m = reads_u8.shape
    c = refs_u8.shape[0]
    if m == 0:
        return torch.zeros((r, c), dtype=torch.int32, device=reads_u8.device)
    best = torch.zeros((r, c, m), dtype=torch.int32, device=reads_u8.device)
    for _, c1 in _unpacked_diagonals(reads_u8, refs_u8, match, mismatch, gap):
        best = torch.maximum(best, c1)
    return best.amax(dim=2)


def score_grid_diag(reads_u8, refs_u8, match, mismatch, gap, *, state_dtype="auto", window_mode="auto"):
    """(R, C) int32 best local score of every (read, ref) pair: K4, the
    anti-diagonal wavefront.

    reads_u8: (R, M) uint8, READ_PAD-padded; refs_u8: (C, N) uint8,
    REF_PAD-padded.  The contract of ``pallas_score_grid_diag`` and
    ``pallas_score_grid_diag_chunked``, with any R (no read block).

    K4's form follows from M and the scheme alone (:func:`k1k4_form`, K1's
    rule): whenever every score provably fits int16 it keeps its DP state
    in 16-bit halves, two reads per warp ("s16x2"), which is what the JAX
    package meant ``state_dtype='int16'`` to be and could not run on its
    TPU; otherwise in int32.  ``state_dtype`` ('auto', 'int32' or
    'int16') is accepted as in the JAX package and does not pick the form:
    every form gives the same scores.  ``window_mode`` ('auto' or 'carry')
    chose how the TPU staged the reference; K4 always streams it through
    shared memory, so 'carry' runs the same kernel.
    """
    if state_dtype not in ("auto", "int32", "int16"):
        raise ValueError(f"state_dtype must be 'auto', 'int32' or 'int16', got {state_dtype!r}")
    if window_mode not in ("auto", "carry"):
        raise ValueError(f"window_mode must be 'auto' or 'carry', got {window_mode!r}")
    return _score_grid_diag(reads_u8, refs_u8, match, mismatch, gap)


def _score_grid_diag(reads_u8, refs_u8, match, mismatch, gap, *, form=None):
    """:func:`score_grid_diag` with K4's form given (``form=None``:
    :func:`k1k4_form`'s), so that the two forms can be timed on the same
    inputs; ``"s16x2"`` where k1k4_form says ``"int32"`` raises."""
    device = _check_grid_inputs("score_grid_diag", reads_u8, refs_u8)
    match, mismatch, gap = int(match), int(mismatch), int(gap)
    form = _check_form("K4", K4_FORMS, form, k1k4_form(reads_u8.shape[1], match, mismatch, gap))
    if device.type == "cpu":
        return score_grid_diag_plain(reads_u8, refs_u8, match, mismatch, gap)
    _check_stripes("score_grid_diag", reads_u8.shape[1], mismatch, gap)
    entry = "swt_score_grid_diag_s16x2" if form == "s16x2" else "swt_score_grid_diag"
    return _launch_grid(entry, "score_grid_diag", K4_FORMS, form, reads_u8, refs_u8, match, mismatch, gap)


# A K5 launch that splits its references aims at this many blocks per SM,
# with segments at least this many propagation windows apart.  K2 and K8
# run one chain of dependent steps a warp (diagonals, rows), so they aim at
# more blocks (K8 with segments of whole tiles, max_cells_segments).
_SPLIT_BLOCKS_PER_SM = 2
_SEGMENT_WINDOWS = 4
_K2_BLOCKS_PER_SM = 8
_K8_BLOCKS_PER_SM = 4
# Columns of one tile of the row form, K5's and K8's (csrc/row_scan.cuh kRowTile).
_ROW_TILE = 512


def row_segments(m: int, n: int, match: int, mismatch: int, gap: int, blocks: int, sms: int):
    """(stride, length) of the column segments into which K5 cuts each
    reference of ``n`` columns, for a launch of ``blocks`` blocks (read
    blocks x references) on a card of ``sms`` SMs: segment k covers the
    columns [k stride, k stride + length), one block each.  (n, n) is one
    segment.

    Exact: with match > 0, mismatch <= 0 and gap < 0 an alignment of
    score > 0 of a read of at most ``m`` positions has fewer than match m
    / |gap| reference gap columns, so it spans at most W = m + match m //
    |gap| columns; segments that overlap by W - 1 hold every run of W
    columns, and the max of their bests is the pair's best
    (``pallas_score._propagation_window`` bounds the same reach).  Only
    reads of at most ONE_PASS_LANES positions under those signs split
    (:func:`_split_stride`); else one segment.
    """
    if not (0 < m <= ONE_PASS_LANES and n > 0 and match > 0 and mismatch <= 0 and gap < 0 and blocks > 0):
        return n, n
    stride = _split_stride(m, n, match, gap, blocks, sms, _SPLIT_BLOCKS_PER_SM)
    return (n, n) if stride >= n else (stride, stride + m + match * m // -gap - 1)


def _split_stride(m: int, n: int, match: int, gap: int, blocks: int, sms: int, per_sm: int) -> int:
    """The stride of K2's and K5's column segments (n: one segment): a
    launch of ``blocks`` blocks splits until it has ``per_sm`` blocks per
    SM, with a stride of at least _SEGMENT_WINDOWS x W (W = m + match m
    // |gap|, match > 0 > gap)."""
    w = m + match * m // -gap
    segs = min(-(-per_sm * sms // blocks), n // (_SEGMENT_WINDOWS * w))
    return n if segs <= 1 else -(-n // segs)


def score_grid_row(reads_u8, refs_u8, match, mismatch, gap):
    """(R, C) int32 best local score of every (read, ref) pair: K5, the
    row form (a scan along each DP row), K4's contract.  Its plain version
    is :func:`..ops.recurrence.score_grid`.

    K5's form follows from M and the scheme alone (:func:`k5_form`, K1's
    and K4's rule without its lane limit, as the row form has no stripes);
    a launch of reads of at most ONE_PASS_LANES positions with too few
    blocks for the card cuts each reference into column segments
    (:func:`row_segments`), which gives the same scores.
    """
    return _score_grid_row(reads_u8, refs_u8, match, mismatch, gap)


def _score_grid_row(reads_u8, refs_u8, match, mismatch, gap, *, form=None, split=True):
    """:func:`score_grid_row` with K5's form given (``form=None``:
    :func:`k5_form`'s), so that the two forms can be timed on the same
    inputs; ``"s16x2"`` where k5_form says ``"int32"`` raises.
    ``split=False`` runs each reference as one segment."""
    device = _check_grid_inputs("score_grid_row", reads_u8, refs_u8)
    match, mismatch, gap = int(match), int(mismatch), int(gap)
    r, m = reads_u8.shape
    c, n = refs_u8.shape
    form = _check_form("K5", K5_FORMS, form, k5_form(m, match, mismatch, gap))
    if device.type == "cpu":
        if m == 0 or n == 0:
            return torch.zeros((r, c), dtype=torch.int32)
        return score_grid(reads_u8, refs_u8, match, mismatch, gap)
    reads_per_block = 2 * _BLOCK_ROWS if form == "s16x2" else _BLOCK_ROWS
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    segments = row_segments(m, n, match, mismatch, gap, -(-r // reads_per_block) * c, sms) if split else (n, n)
    entry = "swt_score_grid_row_s16x2" if form == "s16x2" else "swt_score_grid_row"
    return _launch_grid(entry, "score_grid_row", K5_FORMS, form, reads_u8, refs_u8, match, mismatch, gap, segments)


# -- K8: the cells equal to each read's best ----------------------------------------


def owned_columns(n: int, stride: int, skip: int):
    """[(lo, hi)] of each column segment of K8: the reference's columns
    that segment k lists, segment k covering [k stride, k stride + length)
    (:func:`row_segments`).  Segment 0 lists [0, stride + skip), segment k
    >= 1 [k stride + skip, (k + 1) stride + skip), clipped to n: each
    column once (a last segment may list none).

    A segment starts from H = 0 at its left edge, so its first W - 1
    columns can underestimate H (W = m + match m // |gap|); they also lie
    in the segment before.  With skip >= W - 1 (and length >= stride +
    skip) a segment lists only columns where every positive cell is
    exact: an alignment of positive score spans at most W columns.  One
    segment (stride >= n) lists [0, n)."""
    if n <= 0:
        return []
    return [(0 if k == 0 else min(k * stride + skip, n), min((k + 1) * stride + skip, n))
            for k in range(-(-n // stride))]


def max_cells_segments(m: int, n: int, match: int, mismatch: int, gap: int, blocks: int, sms: int):
    """(stride, length, skip) of K8's column segments for a launch of
    ``blocks`` blocks (read blocks) on a card of ``sms`` SMs; (n, n, 0) is
    one segment.

    A K8 warp is a chain of M dependent row steps a tile of _ROW_TILE
    columns, so where the launch has fewer than _K8_BLOCKS_PER_SM blocks
    per SM the reference is cut into that many segments a read block, each
    of whole tiles: length = stride + skip a multiple of _ROW_TILE, the
    fewest tiles that the target's stride needs, skip = W - 1 (W = m +
    match m // |gap|) the columns at the start of each segment after the
    first that it does not list (:func:`owned_columns`).  The stride may be
    below W: each column is listed by the one segment where it is exact.
    Where the first segment would cover the whole reference (a long read
    against a short one) the plan is one segment.
    Under the signs of :func:`row_segments` only, and for reads of any
    width: the row form has no stripes, so a wide read's segment is the
    one-pass form's with its carried column in a scratch (one per read,
    or pair, and segment)."""
    if not (0 < m and n > 0 and match > 0 and mismatch <= 0 and gap < 0 and blocks > 0):
        return n, n, 0
    segs = -(-_K8_BLOCKS_PER_SM * sms // blocks)
    if segs <= 1:
        return n, n, 0
    skip = m + match * m // -gap - 1
    stride = -(-(-(-n // segs) + skip) // _ROW_TILE) * _ROW_TILE - skip
    # A first segment that already covers the reference lists every column:
    # the others would list none.
    return (n, n, 0) if stride + skip >= n else (stride, stride + skip, skip)


def argwhere_rows(eq: torch.Tensor, capacity: int) -> torch.Tensor:
    """Row-major positions of the true cells of each (M, N) plane.

    eq: (B, M, N) bool.  Returns (B, capacity, 2) int32 (i, j), the first
    ``capacity`` true cells of each plane in row-major order, -1-filled.
    """
    b, _, n = eq.shape
    flat = eq.reshape(b, -1)
    rank = torch.cumsum(flat, dim=1, dtype=torch.int32) - 1
    keep = flat & (rank < capacity)
    pos = torch.full((b, capacity + 1), -1, dtype=torch.int64, device=eq.device)
    slot = torch.where(keep, rank.to(torch.int64), capacity)  # spill slot
    src = torch.arange(flat.shape[1], device=eq.device).expand(b, -1)
    pos.scatter_(1, slot, torch.where(keep, src, -1))
    pos = pos[:, :capacity]
    cells = torch.stack(
        [torch.div(pos, n, rounding_mode="floor"), torch.remainder(pos, n)], dim=-1
    )
    return torch.where(pos[..., None] >= 0, cells, -1).to(torch.int32)


def max_cells_row_plain(reads_u8, ref_u8, best, match, mismatch, gap, capacity):
    """Plain PyTorch version of K8 (any device): the row loop of the JAX
    package's ``_max_cells_device_batch`` into an (R, M, N) int32 stack of
    H, its cells equal to each read's ``best``, then
    :func:`argwhere_rows`.  Memory O(R x M x N)."""
    r, m = reads_u8.shape
    n = ref_u8.shape[-1]
    device = ref_u8.device
    ramp = _ramp(n, gap, device)
    ref_i = ref_u8.to(torch.int32)[None, :]
    reads_i = reads_u8.to(torch.int32)
    h = torch.zeros((r, n), dtype=torch.int32, device=device)
    stack = torch.empty((r, m, n), dtype=torch.int32, device=device)
    for i in range(m):
        sub = _sub_scores(ref_i, reads_i[:, i : i + 1], match, mismatch)
        h, _, _ = _row_update(h, sub, gap, ramp)
        stack[:, i] = h
    eq = stack == best.to(torch.int32)[:, None, None]
    return eq.sum(dim=(1, 2), dtype=torch.int64), argwhere_rows(eq, capacity)


def max_cells_finish_plain(count, cells, best, m, n):
    """Plain PyTorch version of K8's finish (any device): each read's slots
    sorted row-major (empty slots, -1, last) and a read of best 0 given
    count M x N and the first cells of its plane, row-major, -1 past it.
    count (R,) int64 and cells (R, capacity, 2) int32 as the listing left
    them, every slot past a read's count -1."""
    capacity = cells.shape[1]
    device = cells.device
    # Row-major order: a sort of the key i n + j, empty slots last.
    key = torch.where(cells[..., 0] >= 0, cells[..., 0].to(torch.int64) * n + cells[..., 1],
                      torch.iinfo(torch.int64).max)
    cells = cells.gather(1, key.argsort(dim=1)[..., None].expand(-1, -1, 2))
    # best 0: every cell of the M x N plane; best < 0: none.  On the card
    # longseq.find_max_cells passes K5's best, 0 for a read that scores 0
    # (find_max_cells_batched takes such reads out before K8).
    pos = torch.arange(capacity, device=device)
    plane = torch.stack([torch.div(pos, max(n, 1), rounding_mode="floor"), torch.remainder(pos, max(n, 1))], dim=-1)
    plane = torch.where((pos < m * n)[:, None], plane, -1).to(torch.int32)
    zero = (best == 0)
    count = torch.where(zero, m * n, count)
    cells = torch.where(zero[:, None, None], plane[None], cells)
    return count, cells


def max_cells_row(reads_u8, ref_u8, best, match, mismatch, gap, capacity):
    """(count (R,) int64, cells (R, capacity, 2) int32): K8, every DP cell
    of each read against ONE reference whose score equals the read's best.

    reads_u8: (R, M) uint8, READ_PAD-padded; ref_u8: (N,) uint8; best: (R,)
    int32, each read's best score (its max over the DP, as K2's lanes give
    it).  ``count[r]`` is the number of cells (i, j) with H[i][j] ==
    best[r] over the M x N plane; ``cells[r]`` their 0-based (i, j) in
    row-major order, -1-filled.  Where count > capacity only the count is
    part of the contract (the caller lists such a read again with more
    capacity, or scans it on the host).  A read with best 0 gets count M x
    N and the first cells of the plane, as the plain version and the JAX
    package give, by arithmetic and without the kernel.

    K8's form follows from M and the scheme alone (:func:`k5_form`); a
    launch with too few blocks for the card cuts the reference into column
    segments (:func:`max_cells_segments`, reads of any width), which
    gives the same listing.
    On the card a second kernel sorts each read's slots row-major, fills
    the rest with -1 and lists the plane of a read of best 0
    (:func:`max_cells_finish`).
    """
    return _max_cells_row(reads_u8, ref_u8, best, match, mismatch, gap, capacity)


def _max_cells_row(reads_u8, ref_u8, best, match, mismatch, gap, capacity, *, form=None, split=True):
    """:func:`max_cells_row` with K8's form given (``form=None``:
    :func:`k5_form`'s), so that the two forms can be timed on the same
    inputs; ``"s16x2"`` where k5_form says ``"int32"`` raises.
    ``split=False`` runs the reference as one segment.  K8 takes K5's
    rule because its recurrence is K5's row scan (``csrc/row_scan.cuh``),
    which has no stripes, so K5's bound, match x m, holds at any width."""
    device = _device_of(reads_u8, ref_u8, best)
    if reads_u8.dim() != 2 or reads_u8.dtype != torch.uint8:
        raise ValueError("max_cells_row: reads_u8 must be an (R, M) uint8 tensor")
    if ref_u8.dim() != 1 or ref_u8.dtype != torch.uint8:
        raise ValueError("max_cells_row: ref_u8 must be an (N,) uint8 tensor")
    r, m = reads_u8.shape
    n = ref_u8.shape[0]
    if best.shape != (r,) or best.dtype != torch.int32:
        raise ValueError(f"max_cells_row: best must be an ({r},) int32 tensor")
    capacity, match, mismatch, gap = int(capacity), int(match), int(mismatch), int(gap)
    if capacity < 1:
        raise ValueError(f"max_cells_row: capacity must be >= 1, got {capacity}")
    form = _check_form("K8", K8_FORMS, form, k5_form(m, match, mismatch, gap))
    if device.type == "cpu":
        return max_cells_row_plain(reads_u8, ref_u8, best, match, mismatch, gap, capacity)
    count = torch.zeros((r,), dtype=torch.int64, device=device)
    cells = torch.empty((r, capacity, 2), dtype=torch.int32, device=device)
    if r == 0:
        return count, cells
    reads_u8, ref_u8, best = reads_u8.contiguous(), ref_u8.contiguous(), best.contiguous()
    if m > 0 and n > 0:
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        segments = (max_cells_segments(m, n, match, mismatch, gap, _max_cells_blocks(r, m, form), sms)
                    if split else (n, n, 0))
        # Wide reads: one carried column per read and segment, or per pair,
        # segment and warp of the s16x2 form's pipeline of tiles.
        pipeline = _BLOCK_ROWS if form == "s16x2" and m > ONE_PASS_LANES else 1
        carry, part = _carry_grid(m, r, -(-n // segments[0]) * pipeline, n, True, device, pair=form == "s16x2")
        _launch(
            "max_cells_row", "swt_max_cells_row_s16x2" if form == "s16x2" else "swt_max_cells_row",
            reads_u8.data_ptr(), r, m, ref_u8.data_ptr(), n,
            best.data_ptr(), match, mismatch, gap,
            count.data_ptr(), cells.data_ptr(), capacity, _ptr(carry), 0 if carry is None else carry.numel(), part,
            *segments, *_launch_target(device),
        )
        K8_FORMS[form] += 1
    return max_cells_finish(count, cells, best, m, n)


def _max_cells_blocks(r: int, m: int, form: str) -> int:
    """Blocks of a K8 launch of ``r`` reads of ``m`` positions a segment:
    four warps of one read (int32) or pair (s16x2) each, but one pair a
    block in the wide s16x2 form, whose warps take a pair's tiles at once
    (``csrc/max_cells.cu``)."""
    if form != "s16x2":
        return -(-r // _BLOCK_ROWS)
    return -(-r // (2 if m > ONE_PASS_LANES else 2 * _BLOCK_ROWS))


def max_cells_finish(count, cells, best, m, n):
    """(count, cells) of K8's listing finished: each read's filled slots
    (the first min(count, capacity)) in row-major order, -1 past them, and
    a read of best 0 given count M x N and the cells of its plane, as
    :func:`max_cells_finish_plain` (its plain version, taken for CPU
    tensors; there the slots past a read's count must hold -1).  On the
    card one kernel (``csrc/max_cells.cu``) updates count and cells in
    place."""
    device = _device_of(count, cells, best)
    r = best.shape[0]
    if (cells.dim() != 3 or cells.shape[0] != r or cells.shape[2] != 2 or cells.dtype != torch.int32
            or count.shape != (r,) or count.dtype != torch.int64 or best.shape != (r,) or best.dtype != torch.int32):
        raise ValueError("max_cells_finish: count (R,) int64, cells (R, capacity, 2) int32 and best (R,) int32")
    if device.type == "cpu":
        return max_cells_finish_plain(count, cells, best, m, n)
    if not (count.is_contiguous() and cells.is_contiguous() and best.is_contiguous()):
        raise ValueError("max_cells_finish: the card updates count and cells in place: contiguous tensors only")
    capacity = cells.shape[1]
    if r == 0:
        return count, cells
    keys = 1 << (capacity - 1).bit_length()
    scratch = torch.empty(r * keys, dtype=torch.int64, device=device) if keys > _FINISH_KEYS else None
    _launch("max_cells_finish", "swt_max_cells_finish", best.data_ptr(), r, m, n, count.data_ptr(), cells.data_ptr(),
            capacity, _ptr(scratch), keys, *_launch_target(device), count=False)
    return count, cells


# -- K9 and K10: the traceback's fill with direction codes, and its walk ------------


def fill_dirs_plain(reads_u8, refs_u8, match, mismatch, gap, *, tie_semantics, want_h):
    """Plain PyTorch version of K9 (any device):
    :func:`..ops.recurrence.fill_pairs`, a loop of M row updates; H is
    dropped unless ``want_h``."""
    h, dirs = fill_pairs(reads_u8, refs_u8, match, mismatch, gap, tie_semantics=tie_semantics)
    return (h if want_h else None), dirs


def fill_dirs(reads_u8, refs_u8, match, mismatch, gap, *, tie_semantics, want_h):
    """(H (B, M, N) int32 or None, dirs (B, M, N) int8): K9, the full DP
    fill of each read against its reference with the traceback's direction
    codes, :func:`..ops.recurrence.fill_pairs`'s contract.

    reads_u8: (B, M) uint8, READ_PAD-padded; refs_u8: (B, N) uint8, or (1,
    N) for one reference of all B reads.  dirs: 0 none, 1 align, 2
    insertion, 3 deletion, 0 wherever H = 0; ties a > ins > d under
    ``tie_semantics="serial"``, d > ins > a under ``"distributed"``.  H
    (rows 1..M) only when ``want_h``: the windowed traceback needs the codes
    alone.
    """
    device = _device_of(reads_u8, refs_u8)
    if reads_u8.dim() != 2 or reads_u8.dtype != torch.uint8:
        raise ValueError("fill_dirs: reads_u8 must be a (B, M) uint8 tensor")
    b, m = reads_u8.shape
    if refs_u8.dim() != 2 or refs_u8.dtype != torch.uint8 or refs_u8.shape[0] not in (1, b):
        raise ValueError(f"fill_dirs: refs_u8 must be a ({b}, N) or (1, N) uint8 tensor")
    if tie_semantics not in ("serial", "distributed"):
        raise ValueError(f"fill_dirs: tie_semantics must be 'serial' or 'distributed', got {tie_semantics!r}")
    match, mismatch, gap = int(match), int(mismatch), int(gap)
    if device.type == "cpu":
        return fill_dirs_plain(reads_u8, refs_u8, match, mismatch, gap, tie_semantics=tie_semantics, want_h=want_h)
    n = refs_u8.shape[1]
    h = torch.empty((b, m, n), dtype=torch.int32, device=device) if want_h else None
    dirs = torch.empty((b, m, n), dtype=torch.int8, device=device)
    if dirs.numel() == 0:
        return h, dirs
    reads_u8, refs_u8 = reads_u8.contiguous(), refs_u8.contiguous()
    carry = torch.empty(b * m, dtype=torch.int32, device=device) if n > _FILL_TILE else None
    _launch(
        "fill_dirs", "swt_fill_dirs",
        reads_u8.data_ptr(), b, m, refs_u8.data_ptr(), 0 if refs_u8.shape[0] == 1 else n, n,
        match, mismatch, gap, int(tie_semantics == "serial"),
        dirs.data_ptr(), _ptr(h), _ptr(carry), *_launch_target(device),
    )
    return h, dirs


def trace_walk_plain(dirs: torch.Tensor, cells: torch.Tensor, cap: int):
    """Plain PyTorch version of K10 (any device): every (pair, cell) walk in
    lock step, one gather per step, a host sync every _DONE_CHECK steps."""
    b, m, n = dirs.shape
    k = cells.shape[1]
    flat = dirs.reshape(b, m * n)
    i = cells[..., 0].to(torch.int64) + 1
    j = cells[..., 1].to(torch.int64) + 1
    begins = torch.zeros((b, k), dtype=torch.int64, device=dirs.device)
    codes = torch.zeros((b, k, cap), dtype=torch.int8, device=dirs.device)
    for step in range(cap):
        in_bounds = (i > 0) & (j > 0)
        idx = ((i - 1).clamp_min(0) * n + (j - 1).clamp_min(0)).reshape(b, k)
        d = torch.where(in_bounds, flat.gather(1, idx), 0)
        active = d != 0
        if step % _DONE_CHECK == 0 and not bool(active.any()):
            break
        begins = torch.where(active, j, begins)
        i = i - (active & ((d == DIR_ALIGN) | (d == DIR_INS))).to(torch.int64)
        j = j - (active & ((d == DIR_ALIGN) | (d == DIR_DEL))).to(torch.int64)
        codes[..., step] = d
    return begins.to(torch.int32), codes


def trace_walk(dirs: torch.Tensor, cells: torch.Tensor, cap: int):
    """(begins (B, K) int32, codes (B, K, cap) int8): K10, the walk from
    every start cell over its pair's (M, N) direction codes, the JAX
    package's ``_trace_one`` per cell.

    dirs: (B, M, N) int8 (:func:`fill_dirs`); cells: (B, K, 2) int32,
    0-based (i, j) inside the plane, -1 for none.  begins are the 1-based
    start columns (0 for a walk of no step); codes run end to start and are
    0 after the stop (the first 0 code, the matrix edge, or ``cap`` steps).
    """
    device = _device_of(dirs, cells)
    if dirs.dim() != 3 or dirs.dtype != torch.int8:
        raise ValueError("trace_walk: dirs must be a (B, M, N) int8 tensor")
    b, m, n = dirs.shape
    if cells.dim() != 3 or cells.shape[0] != b or cells.shape[2] != 2 or cells.dtype != torch.int32:
        raise ValueError(f"trace_walk: cells must be a ({b}, K, 2) int32 tensor")
    cap = int(cap)
    if cap < 0:
        raise ValueError(f"trace_walk: cap must be >= 0, got {cap}")
    if device.type == "cpu":
        return trace_walk_plain(dirs, cells, cap)
    k = cells.shape[1]
    begins = torch.zeros((b, k), dtype=torch.int32, device=device)
    codes = torch.zeros((b, k, cap), dtype=torch.int8, device=device)
    if b * k == 0 or cap == 0 or m * n == 0:
        return begins, codes
    dirs, cells = dirs.contiguous(), cells.contiguous()
    if cells.data_ptr() % 8:  # the kernel reads each cell as one int2
        cells = cells.clone()
    _launch(
        "trace_walk", "swt_trace_walk",
        dirs.data_ptr(), b, m, n, cells.data_ptr(), k, cap, begins.data_ptr(), codes.data_ptr(),
        *_launch_target(device),
    )
    return begins, codes


# -- K9 and K10 in one launch: fill, list and walk on the card ------------------


def fill_plan(b: int, n: int, sms: int):
    """(columns per lane, warps per pair) of a fill_list or fill_walk
    launch of ``b`` pairs of ``n`` columns on a card of ``sms`` SMs.

    A pair is one block whose warps take its tiles of 32 x cols columns in
    rounds, one tile a warp a round, a row step apart: a chain of about
    rounds x M + warps row steps (``csrc/fill_walk.cu``).  A pair may take
    up to _FILL_WARPS_PER_SM x sms // b warps (1 to _FILL_MAX_WARPS).  The
    plan takes the tile width of fewest rounds; of equal rounds, the widest
    whose launch still puts _FILL_MIN_WARPS_PER_SM warps an SM on the card
    (a wide tile costs fewer instructions a cell: the card is busy), else
    the narrowest (a narrow tile is a shorter row step: the card is idle
    and each pair's chain is the time); then the fewest warps that keep
    those rounds.  A pair's rows do not enter: every tile runs every row."""
    limit = max(1, min(_FILL_MAX_WARPS, _FILL_WARPS_PER_SM * sms // max(1, b)))
    plan = None
    for cols in _FILL_COLS:
        tiles = max(1, -(-n // (32 * cols)))
        rounds = -(-tiles // min(limit, tiles))
        warps = -(-tiles // rounds)
        fills = b * warps >= _FILL_MIN_WARPS_PER_SM * sms
        key = (rounds, not fills, -cols if fills else cols)
        if plan is None or key < plan[0]:
            plan = (key, cols, warps)
    return plan[1], plan[2]


def fill_route(b: int, codes: int, per_sm: int, sms: int) -> str:
    """Where a fill_list or fill_walk launch of ``b`` pairs keeps each
    pair's ``codes`` bytes of 2-bit codes: "shared" (shared memory) where
    they are at most _FILL_SMEM_CODES and every block of the launch finds
    room on the card at once, ``per_sm`` blocks an SM, else "scratch"
    (device memory, walked by the same block): a block that holds its
    codes may take an SM for itself, so a launch of more such blocks than
    fit would run in waves (512 reads x a 4 kb ref: 155.6 KB a pair, one
    block an SM, four waves; ``chip_smoke.py`` [2] times both routes).
    ``per_sm`` is the card's count of the blocks of that launch, with
    their codes in shared memory, that one SM holds at once
    (``swt_fill_blocks_per_sm``: their shared memory as the kernel lays it
    out, the read, the column between rounds, the codes and the listing's
    keys, with their registers and threads; 0 where they pass an SM)."""
    return "shared" if codes <= _FILL_SMEM_CODES and per_sm * sms >= b else "scratch"


def _fill_inputs(what, reads_u8, refs_u8, tie_semantics):
    device = _device_of(reads_u8, refs_u8)
    if reads_u8.dim() != 2 or reads_u8.dtype != torch.uint8:
        raise ValueError(f"{what}: reads_u8 must be a (B, M) uint8 tensor")
    b, m = reads_u8.shape
    if refs_u8.dim() != 2 or refs_u8.dtype != torch.uint8 or refs_u8.shape[0] not in (1, b):
        raise ValueError(f"{what}: refs_u8 must be a ({b}, N) or (1, N) uint8 tensor")
    if m == 0 or refs_u8.shape[1] == 0 or m * refs_u8.shape[1] >= 1 << 31:
        raise ValueError(f"{what}: a pair's plane must hold 1 to 2^31 - 1 cells, got {m} x {refs_u8.shape[1]}")
    if tie_semantics not in ("serial", "distributed"):
        raise ValueError(f"{what}: tie_semantics must be 'serial' or 'distributed', got {tie_semantics!r}")
    return device


def _fill_route_of(reads_u8, refs_u8, tie_semantics, capacity=0):
    """The route :func:`fill_route` picks for a launch of these inputs on
    their card (``capacity`` 0: fill_walk's launch)."""
    b, m = reads_u8.shape
    n = refs_u8.shape[1]
    device = reads_u8.device
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    cols, warps = fill_plan(b, n, sms)
    codes = m * -(-n // (32 * cols)) * 8 * cols
    per_sm = ctypes.c_int(0)
    if codes <= _FILL_SMEM_CODES:
        rc = _cuda.lib().swt_fill_blocks_per_sm(int(capacity > 0), int(tie_semantics == "serial"), m, n, cols, warps,
                                                capacity, _launch_target(device)[0], ctypes.byref(per_sm))
        _cuda.check(rc, "fill_blocks_per_sm")
    return fill_route(b, codes, per_sm.value, sms)


def _fill_launch(reads_u8, refs_u8, route, tie_semantics, capacity=0):
    """The arguments that both C entries share, from the plan: (cols,
    warps, code scratch or None, stride, tiles); ``capacity`` 0 for
    fill_walk's launch."""
    b, m = reads_u8.shape
    n = refs_u8.shape[1]
    sms = torch.cuda.get_device_properties(reads_u8.device).multi_processor_count
    cols, warps = fill_plan(b, n, sms)
    tiles = -(-n // (32 * cols))
    stride = tiles * 8 * cols  # bytes of 2-bit codes a row
    route = route or _fill_route_of(reads_u8, refs_u8, tie_semantics, capacity)
    scratch = torch.empty(b * m * stride, dtype=torch.uint8, device=reads_u8.device) if route == "scratch" else None
    return cols, warps, scratch, stride, tiles


def fill_list_plain(reads_u8, refs_u8, match, mismatch, gap, *, capacity, cap, tie_semantics):
    """Plain PyTorch version of :func:`fill_list` (any device): K9's plain
    version with H, the best and the cells equal to it
    (:func:`argwhere_rows`), then K10's plain walk."""
    h, dirs = fill_dirs_plain(reads_u8, refs_u8, match, mismatch, gap, tie_semantics=tie_semantics, want_h=True)
    best = h.amax(dim=(1, 2))
    eq = h == best[:, None, None]
    counts = eq.sum(dim=(1, 2), dtype=torch.int32)
    cells = argwhere_rows(eq, capacity)
    begins, codes = trace_walk_plain(dirs, cells, cap)
    return best, counts, cells, begins, codes


def fill_list(reads_u8, refs_u8, match, mismatch, gap, *, capacity, cap, tie_semantics):
    """(best (B,) int32, counts (B,) int32, cells (B, capacity, 2) int32,
    begins (B, capacity) int32, codes (B, capacity, cap) int8): the
    full-fill branch's fill, listing and walks, the JAX package's
    ``device_traceback.fill_and_trace``.

    reads_u8: (B, M) uint8, READ_PAD-padded; refs_u8: (B, N) uint8, or (1,
    N) for one reference of all B reads.  ``best`` is each pair's max over
    its (M, N) plane, pad rows and REF_PAD columns included; ``counts`` the
    number of cells equal to it there; ``cells`` the first ``capacity`` of
    them in row-major order, -1-filled (also where the count passes
    ``capacity``); ``begins`` and ``codes`` the walk from each cell, as
    :func:`trace_walk` gives them over :func:`fill_dirs`'s codes.

    On the card one launch (``csrc/fill_walk.cu``) does it all; no H and no
    plane of codes reaches device memory."""
    return _fill_list(reads_u8, refs_u8, match, mismatch, gap, capacity=capacity, cap=cap,
                      tie_semantics=tie_semantics)


def _fill_list(reads_u8, refs_u8, match, mismatch, gap, *, capacity, cap, tie_semantics, route=None):
    """:func:`fill_list` with the codes' route given ("shared" or
    "scratch"; None: :func:`fill_route`'s), so that both routes can be held
    to the plain version and timed."""
    device = _fill_inputs("fill_list", reads_u8, refs_u8, tie_semantics)
    if route not in (None, "shared", "scratch"):
        raise ValueError(f"fill_list: no route {route!r}")
    capacity, cap = int(capacity), int(cap)
    if capacity < 1 or cap < 0:
        raise ValueError(f"fill_list: capacity must be >= 1 and cap >= 0, got {capacity} and {cap}")
    match, mismatch, gap = int(match), int(mismatch), int(gap)
    if device.type == "cpu":
        return fill_list_plain(reads_u8, refs_u8, match, mismatch, gap, capacity=capacity, cap=cap,
                               tie_semantics=tie_semantics)
    b, m = reads_u8.shape
    n = refs_u8.shape[1]
    i32 = dict(dtype=torch.int32, device=device)
    best, counts = torch.empty(b, **i32), torch.empty(b, **i32)
    cells, begins = torch.empty((b, capacity, 2), **i32), torch.empty((b, capacity), **i32)
    codes = torch.zeros((b, capacity, cap), dtype=torch.int8, device=device)
    if b == 0:
        return best, counts, cells, begins, codes
    reads_u8, refs_u8 = reads_u8.contiguous(), refs_u8.contiguous()
    cols, warps, scratch, stride, tiles = _fill_launch(reads_u8, refs_u8, route, tie_semantics, capacity)
    lists = torch.empty(b * tiles * capacity, dtype=torch.int64, device=device)
    meta = torch.empty((b, tiles, 2), **i32)
    keys = 1 << (tiles * capacity - 1).bit_length()
    sort = torch.empty(b * keys, dtype=torch.int64, device=device) if keys > _FILL_SORT_KEYS else None
    _launch(
        "fill_list", "swt_fill_list",
        reads_u8.data_ptr(), b, m, refs_u8.data_ptr(), 0 if refs_u8.shape[0] == 1 else n, n,
        match, mismatch, gap, int(tie_semantics == "serial"), cols, warps, _ptr(scratch), stride,
        capacity, cap, best.data_ptr(), counts.data_ptr(), cells.data_ptr(), begins.data_ptr(), codes.data_ptr(),
        lists.data_ptr(), meta.data_ptr(), _ptr(sort), keys, *_launch_target(device),
    )
    return best, counts, cells, begins, codes


def _check_known_cells(cells, m, n):
    """Raises ValueError unless every cell is inside the (m, n) plane or
    (-1, -1), none (one host sync on the card)."""
    inside = (cells >= 0).all(dim=1) & (cells[:, 0] < m) & (cells[:, 1] < n)
    with profiling.span("wait", on="readback"):
        known = bool((inside | (cells == -1).all(dim=1)).all())
    if not known:
        raise ValueError(f"fill_walk: every cell must lie inside the ({m}, {n}) plane or be (-1, -1)")


def fill_walk_plain(reads_u8, refs_u8, cells, match, mismatch, gap, *, cap, tie_semantics):
    """Plain PyTorch version of :func:`fill_walk` (any device): K9's plain
    version (the codes) and K10's plain walk of one cell a pair."""
    _check_known_cells(cells, reads_u8.shape[1], refs_u8.shape[1])
    _, dirs = fill_dirs_plain(reads_u8, refs_u8, match, mismatch, gap, tie_semantics=tie_semantics, want_h=False)
    begins, codes = trace_walk_plain(dirs, cells[:, None, :], cap)
    return begins[:, 0], codes[:, 0]


def fill_walk(reads_u8, refs_u8, cells, match, mismatch, gap, *, cap, tie_semantics):
    """(begins (B,) int32, codes (B, cap) int8): the windowed branch's fill
    of each window and walk from its one known max cell, the JAX
    package's ``longseq._fill_walk_known``.

    reads_u8: (B, M) uint8; refs_u8: (B, W) uint8 windows (or (1, W));
    cells: (B, 2) int32, each pair's 0-based (i, j) inside the (M, W)
    plane, or (-1, -1) for a walk of no step; any other cell raises
    ValueError.  begins and codes as :func:`trace_walk`
    gives them over :func:`fill_dirs`'s codes.

    On the card one launch (``csrc/fill_walk.cu``) fills each window down
    to its cell's row and walks it; no plane of codes reaches device memory
    on route "shared"."""
    return _fill_walk(reads_u8, refs_u8, cells, match, mismatch, gap, cap=cap, tie_semantics=tie_semantics)


def _fill_walk(reads_u8, refs_u8, cells, match, mismatch, gap, *, cap, tie_semantics, route=None):
    """:func:`fill_walk` with the codes' route given (see :func:`_fill_list`)."""
    device = _fill_inputs("fill_walk", reads_u8, refs_u8, tie_semantics)
    if route not in (None, "shared", "scratch"):
        raise ValueError(f"fill_walk: no route {route!r}")
    b, m = reads_u8.shape
    n = refs_u8.shape[1]
    if cells.device != device or cells.shape != (b, 2) or cells.dtype != torch.int32:
        raise ValueError(f"fill_walk: cells must be a ({b}, 2) int32 tensor on {device}")
    cap = int(cap)
    if cap < 0:
        raise ValueError(f"fill_walk: cap must be >= 0, got {cap}")
    match, mismatch, gap = int(match), int(mismatch), int(gap)
    if device.type == "cpu":
        return fill_walk_plain(reads_u8, refs_u8, cells, match, mismatch, gap, cap=cap, tie_semantics=tie_semantics)
    _check_known_cells(cells, m, n)
    begins = torch.empty(b, dtype=torch.int32, device=device)
    codes = torch.zeros((b, cap), dtype=torch.int8, device=device)
    if b == 0:
        return begins, codes
    reads_u8, refs_u8, cells = reads_u8.contiguous(), refs_u8.contiguous(), cells.contiguous()
    if cells.data_ptr() % 8:  # the kernel reads each cell as one int2
        cells = cells.clone()
    cols, warps, scratch, stride, _ = _fill_launch(reads_u8, refs_u8, route, tie_semantics)
    _launch(
        "fill_walk", "swt_fill_walk",
        reads_u8.data_ptr(), b, m, refs_u8.data_ptr(), 0 if refs_u8.shape[0] == 1 else n, n,
        match, mismatch, gap, int(tie_semantics == "serial"), cols, warps, _ptr(scratch), stride,
        cells.data_ptr(), cap, begins.data_ptr(), codes.data_ptr(), *_launch_target(device),
    )
    return begins, codes


# -- K6 and K7: the TPU's step-chain probes ---------------------------------------


def _check_lane_row(what: str, m: int, lanes_per_thread) -> None:
    """K6 and K7 hold a row in one warp, 32 threads x L lanes exactly."""
    if m % 32 or m // 32 not in lanes_per_thread:
        widths = ", ".join(str(32 * l) for l in lanes_per_thread)
        raise ValueError(f"{what} takes rows of {widths} lanes on CUDA, got {m}")


def step_form(m: int, steps: int, match: int, mismatch: int, gap: int, *, variant=None, masked: bool = False,
              lane0_starts: bool = False) -> str:
    """The form of one K6 call (``variant=None``) or K7 call (``variant``
    one of :data:`STEP_VARIANTS`) on rows of ``m`` lanes that runs
    ``steps`` steps: ``"s16x2"`` (two rows per warp, one in each 16-bit
    half of every register, the step in DPX instructions) when every value
    and every intermediate provably fits int16, else ``"int32"``.
    ``lane0_starts`` (K6 only): every row of K6's input has START_BIT on
    lane 0 (K6 reads it from the data, :func:`k6_form`); ``masked``: K6's
    moving boundary.  K7's rule reads no data.

    :func:`k1_form`'s proof does not hold here: it rests on lane 0 always
    starting a segment, and K6 and K7 shift with the TPU's circular roll,
    so a row whose lane 0 is not a start keeps growing around the ring
    (the JAX microbench's inputs, codes 2-5 with no start bit, are such
    rows: row 0 compares with itself and gains ``match`` every two steps).

    The proof.  Under k1_form's signs (0 <= match, -32768 <= mismatch,
    gap <= 0, m <= ONE_PASS_LANES), with c1(t) the value a lane computes on
    step t (before any mask) and V(t) its max over lanes:

    - c1(t) = max(0, r2 + sub, max(r1, d1) + gap) where r2 is a value of
      step t - 2 and r1, d1 of step t - 1 (or 0), and sub <= match; masks
      only zero values.  So V(t) <= max(0, V(t - 2) + match, V(t - 1)),
      and by induction V(t) <= match * ceil((t + 1) / 2): a call of S steps
      keeps every value at most match * ceil(S / 2).  Only a diagonal move
      adds to a value, and it spans two steps.
    - When the shift zeroes lane 0 on every step (K7's B; K6 when every
      row has START_BIT on lane 0), lane 0's r2 and r1 are
      0, and lane i's come from lane i - 1: by induction over the steps,
      lane i holds at most match * (i + 1), so every value is at most
      match * m.
    - In the masked K6 at m = 1024, lane 1023 is never live (lanes i >=
      (s & 1023) are dead), so its state stays 0 and its value is at most
      match; that value is all the wrap hands lane 0, and the same
      induction gives lane i <= match * (i + 2) for i <= 1022: every value
      is at most match * m.  At m < 1024 the boundary gives no bound: once
      s & 1023 >= m every lane is live, and a value rides the ring from
      lane m - 1 at step 1023 of one block into lane 0 at step 1 of the
      next (row 0 of the microbench's inputs at 256 lanes reaches 10,240
      after 4,096 masked steps, as unmasked).

    Every intermediate lies within the bound B (the tightest that applies)
    and min(mismatch, gap): r2 + sub and max(r1, d1) + gap are terms of a
    max that is at most B, and at least mismatch or gap since the values
    are >= 0.  K7's substitution is sweep_s16x2's IMAD
    (``csrc/wavefront.cuh``): V = r2 + e (match - mismatch) over both
    halves of a 32-bit register, e 0 or 1 per half; r2 + match is itself a
    bound of a later step's term (<= B), so each half of V is at most
    B - mismatch <= 65535 and nothing carries into the high half, and V +
    mismatch wraps back to r2 + sub.  K6's sub is made once per register
    before the loop, so its step has no IMAD.  So s16x2 is admitted when B
    <= 32767.  Variant C stays int32: its point is the multiply by "not a
    start", and there is no 16x2 integer multiply.

    K6's ``lane0_starts`` costs one device reduction over its input and one
    host sync per call of :func:`step_chain_best` (:func:`k6_form`, only
    when the other bounds do not already decide): 0.124 ms of a 2.75 ms
    call on 512 x 128 rows of 131,072 steps (4.5%; NVIDIA H100 80GB HBM3,
    700.00 W, ``chip_smoke.py`` [11]), more where the host is slow to
    resume after the sync.  A caller that passes ``form="int32"`` reads
    nothing (the rule only refuses ``"s16x2"``), and a timed loop reads the
    rows once before it (``ops.microbench.step_roofline``).
    """
    if variant is not None and variant not in STEP_VARIANTS:
        raise ValueError(f"variant must be one of {STEP_VARIANTS}, got {variant!r}")
    if lane0_starts and variant is not None:
        raise ValueError("lane0_starts is K6's (variant=None): K7's rule reads no data")
    signs = 0 <= match and _INT16_MIN <= min(mismatch, gap) and max(mismatch, gap) <= 0
    if not signs or m > ONE_PASS_LANES or variant == "C":
        return "int32"
    bound = match * -(-int(steps) // 2)
    lane0 = variant == "B" or (lane0_starts and variant is None)
    if lane0 or (variant is None and masked and m >= ONE_PASS_LANES):
        bound = min(bound, match * m)
    return "s16x2" if bound <= _INT16_MAX else "int32"


def lane0_starts(reads: torch.Tensor) -> bool:
    """Whether every row of K6's (RB, M) input has START_BIT on lane 0
    (one reduction and one sync on the card)."""
    return reads.shape[0] == 0 or int(reads[:, 0].min()) >= START_BIT


def k6_form(reads: torch.Tensor, steps: int, match: int, mismatch: int, gap: int, masked: bool,
            starts=None) -> str:
    """K6's form for one call (:func:`step_form` of the steps that run).
    ``starts``: :func:`lane0_starts` of ``reads`` where the caller has it;
    None reads it (one reduction and one sync), only when that could
    change the answer."""
    m = reads.shape[1]
    form = step_form(m, steps, match, mismatch, gap, masked=masked)
    if form == "int32" and step_form(m, steps, match, mismatch, gap, masked=masked, lane0_starts=True) == "s16x2":
        starts = lane0_starts(reads) if starts is None else starts
        form = step_form(m, steps, match, mismatch, gap, masked=masked, lane0_starts=starts)
    return form


def step_chain_best_plain(reads, steps, unroll, match, mismatch, gap, masked):
    """Plain PyTorch version of K6 (any device): the step loop on the
    (RB, M) state."""
    rb, m = reads.shape
    read = reads & (START_BIT - 1)
    start = reads >= START_BIT
    sub = torch.where(read == read[:1], match, mismatch).to(torch.int32)
    col = torch.arange(m, device=reads.device)
    d1 = torch.zeros((rb, m), dtype=torch.int32, device=reads.device)
    r1 = torch.zeros_like(d1)
    r2 = torch.zeros_like(d1)
    best = torch.zeros_like(d1)
    skip = unroll - 1 if unroll % 2 and not masked else -1
    for s in range(steps // unroll * unroll):
        c1 = torch.clamp_min(torch.maximum(r2 + sub, torch.maximum(r1, d1) + gap), 0)
        rc = torch.roll(c1, 1, dims=1).masked_fill_(start, 0)
        if masked:
            dead = col >= (s & 1023)
            c1 = c1.masked_fill_(dead, 0)
            rc = rc.masked_fill_(dead, 0)
        if s % unroll != skip:
            best = torch.maximum(best, c1)
        d1, r2, r1 = c1, r1, rc
    return best


def step_chain_best(reads, *, steps, unroll=64, match=5, mismatch=-3, gap=-4, masked=False):
    """(RB, M) int32 best of each lane over a chain of ``steps`` wavefront
    steps with a constant substitution row and no memory traffic: K6.

    reads: (RB, M) int32, a code in the low byte and ``START_BIT`` on
    lanes that restart the DP.  Lane i of every row compares its code
    with row 0's code at lane i, on every step.  The i-1 shift is the
    TPU's circular roll: lane 0 takes lane M-1's value unless it is a
    start lane.  ``steps // unroll`` bodies of ``unroll`` steps run; the
    best counts every step of a body, except that with an odd ``unroll``
    and ``masked=False`` each body's last step is left out
    (``microbench.py:_roofline_kernel`` takes its max over pairs of steps).

    ``masked=True`` is ``triangle_timepack.py:_chain_kernel``: on step s,
    lanes i >= (s & 1023) are zeroed in both the new values and the
    shifted ones, and every step counts.

    On the card the form follows from the data (:func:`k6_form`, which
    may read lane 0 of every row): two rows per warp in 16-bit halves
    where every value provably fits int16, else int32.
    """
    return _step_chain_best(reads, steps=steps, unroll=unroll, match=match, mismatch=mismatch, gap=gap,
                            masked=masked)


def _step_chain_best(reads, *, steps, unroll=64, match=5, mismatch=-3, gap=-4, masked=False, form=None,
                     starts=None):
    """:func:`step_chain_best` with K6's form given (``form=None``:
    :func:`k6_form`'s), so that the two forms can be timed on the same
    inputs; ``"s16x2"`` where the rule says ``"int32"`` raises, and
    ``"int32"`` reads no data.  ``starts``: :func:`lane0_starts` of
    ``reads``, read once by a caller that times many calls on them."""
    device = _device_of(reads)
    if reads.dim() != 2 or reads.dtype != torch.int32:
        raise ValueError("reads must be an (RB, M) int32 tensor")
    steps, unroll, masked = int(steps), int(unroll), bool(masked)
    if steps < 0:
        raise ValueError(f"steps must be >= 0, got {steps}")
    # The roofline body keeps a max over pairs of steps, so with one step
    # per body it has none (the JAX kernel fails to trace).
    if unroll < 1 or (unroll == 1 and not masked):
        raise ValueError(f"unroll must be >= {1 if masked else 2}, got {unroll}")
    match, mismatch, gap = int(match), int(mismatch), int(gap)
    if form != "int32" and (form is not None or device.type != "cpu"):
        form = _check_form("K6", K6_FORMS, form, k6_form(reads, steps // unroll * unroll, match, mismatch, gap,
                                                           masked, starts))
    if device.type == "cpu":
        return step_chain_best_plain(reads, steps, unroll, match, mismatch, gap, masked)
    rb, m = reads.shape
    _check_lane_row("step_chain_best", m, _LANES_PER_THREAD)
    out = torch.empty((rb, m), dtype=torch.int32, device=device)
    if rb == 0:
        return out
    reads = reads.contiguous()
    _launch(
        "step_chain_best", "swt_step_chain_best_s16x2" if form == "s16x2" else "swt_step_chain_best",
        reads.data_ptr(), rb, m, steps, unroll, match, mismatch, gap, int(masked),
        out.data_ptr(), *_launch_target(device),
    )
    K6_FORMS[form] += 1
    return out


# The variants of ``packed_step_variants.py``: how the i-1 shift treats
# lane 0 and the start lanes, and whether the suffix max runs.
STEP_VARIANTS = ("A", "B", "C", "D", "E")
_VARIANT_LANES = (1, 2, 4, 8, 16, 32)


def variant_steps(m: int, n: int, unroll: int) -> int:
    """Steps K7 runs: the m + n - 1 diagonals rounded up to whole bodies."""
    return -(-(m + n - 1) // unroll) * unroll


def step_variant_best_plain(packed, refs_u8, variant, unroll, match, mismatch, gap):
    """Plain PyTorch version of K7 (any device): the diagonal loop on a
    (C, ROWS, M) state."""
    rows, m = packed.shape
    c, n = refs_u8.shape
    device = packed.device
    read = (packed & (START_BIT - 1))[None]
    start = packed >= START_BIT
    lane0 = torch.zeros_like(start)
    lane0[:, 0] = True
    nonstart = (~start).to(torch.int32)
    refs_i = refs_u8.to(torch.int32)
    lens = torch.full((c,), n, dtype=torch.int64, device=device)
    d1 = torch.zeros((c, rows, m), dtype=torch.int32, device=device)
    r1 = torch.zeros_like(d1)
    r2 = torch.zeros_like(d1)
    best = torch.zeros_like(d1)
    for d in range(variant_steps(m, n, unroll)):
        win = _ref_window(refs_i, lens, d, m)[:, None, :]
        sub = torch.where(read == win, match, mismatch).to(torch.int32)
        c1 = torch.clamp_min(torch.maximum(r2 + sub, torch.maximum(r1, d1) + gap), 0)
        rolled = torch.roll(c1, 1, dims=2)
        if variant in ("A", "E"):
            rc = rolled.masked_fill(start, 0)
        elif variant == "B":
            rc = rolled.masked_fill(lane0, 0)
        elif variant == "C":
            rc = rolled * nonstart
        else:
            rc = rolled
        best = torch.maximum(best, c1)
        d1, r2, r1 = c1, r1, rc
    return best if variant == "E" else segmented_suffix_max(best, start)


def step_variant_best(packed, refs_u8, *, variant, unroll=16, match=5, mismatch=-3, gap=-4):
    """(C, ROWS, M) int32 lane bests of packed rows against C references
    under one of the step variants A-E of ``packed_step_variants.py``: K7.

    packed: (ROWS, M) int32 with ``START_BIT`` on segment starts;
    refs_u8: (C, N) uint8.  Lane i on step d sees ``ref[d - i]``, REF_PAD
    outside [0, N); :func:`variant_steps` steps run, all of which count.
    The i-1 shift is the TPU's circular roll, then: A zeroes start lanes
    (the packed kernels' step), B zeroes lane 0 only, C multiplies by
    "not a start" (equal to A), D keeps the wrap, E is A.  A-D end in the
    segmented suffix max over the start lanes; E returns the raw lane
    bests.  B and D are wrong Smith-Waterman on purpose: the JAX script
    timed them, and K7 reproduces them exactly.

    On the card the form follows from the shape and the scheme
    (:func:`step_form`, no data read): 16-bit halves, two rows per warp,
    where every value provably fits int16 (never for C), else int32.
    """
    return _step_variant_best(packed, refs_u8, variant=variant, unroll=unroll, match=match, mismatch=mismatch,
                              gap=gap)


def _step_variant_best(packed, refs_u8, *, variant, unroll=16, match=5, mismatch=-3, gap=-4, form=None):
    """:func:`step_variant_best` with K7's form given (``form=None``:
    :func:`step_form`'s), so that the two forms can be timed on the same
    inputs; ``"s16x2"`` where the rule says ``"int32"`` raises."""
    if variant not in STEP_VARIANTS:
        raise ValueError(f"variant must be one of {STEP_VARIANTS}, got {variant!r}")
    device = _device_of(packed, refs_u8)
    if packed.dim() != 2 or packed.dtype != torch.int32:
        raise ValueError("packed must be a (ROWS, M) int32 tensor")
    if refs_u8.dim() != 2 or refs_u8.dtype != torch.uint8:
        raise ValueError("refs_u8 must be a (C, N) uint8 tensor")
    unroll = int(unroll)
    if unroll < 1:
        raise ValueError(f"unroll must be >= 1, got {unroll}")
    match, mismatch, gap = int(match), int(mismatch), int(gap)
    rows, m = packed.shape
    c, n = refs_u8.shape
    steps = variant_steps(m, n, unroll)
    form = _check_form("K7", K7_FORMS, form, step_form(m, steps, match, mismatch, gap, variant=variant))
    if device.type == "cpu":
        return step_variant_best_plain(packed, refs_u8, variant, unroll, match, mismatch, gap)
    _check_lane_row("step_variant_best", m, _VARIANT_LANES)
    out = torch.empty((c, rows, m), dtype=torch.int32, device=device)
    if c == 0 or rows == 0:
        return out
    packed = packed.contiguous()
    refs_u8 = refs_u8.contiguous()
    _launch(
        "step_variant_best", "swt_step_variant_best_s16x2" if form == "s16x2" else "swt_step_variant_best",
        packed.data_ptr(), rows, m, refs_u8.data_ptr(), c, n,
        STEP_VARIANTS.index(variant), steps, match, mismatch, gap,
        out.data_ptr(), *_launch_target(device),
    )
    K7_FORMS[form] += 1
    return out
