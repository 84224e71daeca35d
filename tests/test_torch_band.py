"""K3's plain version (``band_lane_best_plain``: packed reads against one
reference segment, left boundary column in, right column out) against the
JAX package's ``pallas_band_lane_best`` (interpret mode, tiny shapes), a
row-by-row NumPy statement of the band's DP, and, chained over segments,
the whole-reference K1 and the JAX recurrence.

Contract lanes: ``lane_best`` at each segment's START lane, ``bnd_out``
at every lane (the TPU kernel's at the lanes of reads)."""

import numpy as np
import pytest
import torch

from sparksmithwaterman_tpu.io.fasta import READ_PAD as JAX_READ_PAD
from sparksmithwaterman_tpu.io.fasta import REF_PAD as JAX_REF_PAD
from sparksmithwaterman_tpu.io.fasta import encode_batch as jax_encode_batch
from sparksmithwaterman_tpu.ops.pallas_score import pallas_band_lane_best
from sparksmithwaterman_tpu.ops.recurrence import score_grid
from sparksmithwaterman_tpu_torch.io.fasta import REF_PAD, encode_concat
from sparksmithwaterman_tpu_torch.ops import cuda_score
from sparksmithwaterman_tpu_torch.ops.packing import START_BIT, pack_reads

torch.set_num_threads(1)

PARAMS = (5, -3, -4)
_BASES = np.array(list("ACGT"))


def _seqs(rng, lens):
    return ["".join(rng.choice(_BASES, size=int(l))) for l in lens]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _band_oracle(packed, segs, ns, bnd):
    """(lane_best at start lanes, bnd_out), NumPy, one DP row at a time.

    segs[c]: the segment's uint8 codes (REF_PAD past them up to ns[c]);
    bnd: (C, ROWS, M).  Every packed segment (reads and pad runs alike) is
    its own DP: zero row above its first lane, H[i, -1] = bnd[i], and
    H[i - 1, -1] as the NW term of column 0."""
    match, mismatch, gap = PARAMS
    rows, m = packed.shape
    code = packed & (START_BIT - 1)
    start = (packed >= START_BIT) | (np.arange(m) == 0)
    best = np.zeros((len(ns), rows, m), np.int64)
    bout = np.zeros_like(best)
    for c, n in enumerate(ns):
        ref = np.full(n, REF_PAD, np.int64)
        ref[: len(segs[c])] = segs[c]
        ramp = gap * np.arange(n)
        for r in range(rows):
            for i in range(m):
                if start[r, i]:
                    a, h, corner = i, np.zeros(n, np.int64), 0
                sub = np.where(ref == code[r, i], match, mismatch)
                nw = np.concatenate(([corner], h[:-1]))
                cand = np.maximum(np.maximum(nw + sub, h + gap), 0)
                h = np.maximum(np.maximum.accumulate(cand - ramp) + ramp, bnd[c, r, i] + gap * (np.arange(n) + 1))
                corner = bnd[c, r, i]
                best[c, r, a] = max(best[c, r, a], h.max())
                bout[c, r, i] = h[-1]
    return best, bout, start


def _band(packed, refs, ns, bnd):
    """K3 (plain, on the CPU) over one segment of each ref in ``refs``,
    given as one flat buffer read by offset."""
    flat, lens = encode_concat(refs)
    offsets = np.concatenate(([0], np.cumsum(lens)[:-1])).astype(np.int64)
    return cuda_score.band_lane_best(
        _t(packed), _t(flat), _t(offsets), _t(lens.astype(np.int32)), _t(np.asarray(ns, np.int32)), _t(bnd), *PARAMS
    )


@pytest.mark.parametrize(
    "m_pack, seg_len, ns", [(128, 120, 120), (256, 90, 90), (128, 0, 40)], ids=["m128", "m256", "all_pad"]
)
def test_plain_matches_pallas_band(m_pack, seg_len, ns):
    rng = np.random.default_rng(m_pack + seg_len)
    reads = _seqs(rng, [60, 40, min(200, m_pack - 56), 25, 0])
    seg = _seqs(rng, [seg_len])[0]
    packed, start = pack_reads(reads, m_pack)
    bnd = rng.integers(0, 60, size=(1,) + packed.shape).astype(np.int32)
    lane, bout = _band(packed, [seg], [ns], bnd)
    seg_enc = jax_encode_batch([seg], ns, JAX_REF_PAD)[0]
    want_lane, want_bout = (
        np.asarray(x)
        for x in pallas_band_lane_best(packed, seg_enc, bnd[0], *PARAMS, read_block=8, unroll=8, interpret=True)
    )
    np.testing.assert_array_equal(lane[0].reshape(-1)[start].numpy(), want_lane.reshape(-1)[start])
    read_lanes = np.concatenate([s + np.arange(max(1, len(r))) for r, s in zip(reads, start)])
    np.testing.assert_array_equal(bout[0].reshape(-1)[read_lanes].numpy(), want_bout.reshape(-1)[read_lanes])
    best, want_all, starts = _band_oracle(packed, [np.frombuffer(seg.encode(), np.uint8)], [ns], bnd)
    np.testing.assert_array_equal(bout.numpy(), want_all)
    np.testing.assert_array_equal(lane.numpy()[:, starts], best[:, starts])


@pytest.mark.parametrize("bnd_kind", ["zero", "random"])
@pytest.mark.parametrize("m_pack", [128, 256])
def test_plain_matches_band_oracle(m_pack, bnd_kind):
    """Mixed segments in one call: full, tail (REF_PAD past its bytes),
    all pad, length 0 with one column; empty reads and pad rows."""
    rng = np.random.default_rng(m_pack + len(bnd_kind))
    reads = _seqs(rng, rng.integers(1, 90, size=7)) + ["", "ACGT"]
    refs = _seqs(rng, [50, 23, 0, 0, 1])
    ns = [50, 40, 17, 1, 3]
    packed, _ = pack_reads(reads, m_pack, row_multiple=4)
    shape = (len(refs),) + packed.shape
    bnd = np.zeros(shape, np.int32) if bnd_kind == "zero" else rng.integers(0, 90, size=shape).astype(np.int32)
    lane, bout = _band(packed, refs, ns, bnd)
    best, want_bout, starts = _band_oracle(packed, [np.frombuffer(r.encode(), np.uint8) for r in refs], ns, bnd)
    np.testing.assert_array_equal(bout.numpy(), want_bout)
    np.testing.assert_array_equal(lane.numpy()[:, starts], best[:, starts])


@pytest.mark.parametrize("num_segs", [1, 2, 3, 5])
def test_chained_plain_equals_whole_reference(num_segs):
    """Segments chained left to right through the boundary columns (zero
    into the first) and maxed at the start lanes equal K1's plain version
    on the whole reference and the JAX recurrence; one read is planted
    across a segment edge, one reference is shorter than the segment
    count (whole segments of pad)."""
    rng = np.random.default_rng(23 + num_segs)
    reads = _seqs(rng, [50, 30, 70, 20, 0])
    base = _seqs(rng, [240])[0]
    mid = 120 - 25
    refs = [base[:mid] + reads[0] + base[mid + 50 :], _seqs(rng, [77])[0], "G", ""]
    packed, start = pack_reads(reads, 128)
    flat, lens = encode_concat(refs)
    offsets = np.concatenate(([0], np.cumsum(lens)[:-1])).astype(np.int64)
    ns = np.maximum(1, -(-lens // num_segs))
    bnd = torch.zeros((len(refs),) + packed.shape, dtype=torch.int32)
    got = None
    for s in range(num_segs):
        seg_lens = np.clip(lens - s * ns, 0, ns)
        seg_offs = np.where(seg_lens > 0, offsets + s * ns, 0)
        lane, bnd = cuda_score.band_lane_best(
            _t(packed), _t(flat), _t(seg_offs), _t(seg_lens.astype(np.int32)), _t(ns.astype(np.int32)), bnd, *PARAMS
        )
        scores = lane.reshape(len(refs), -1)[:, start]
        got = scores if got is None else torch.maximum(got, scores)
    whole = cuda_score.lane_best_packed_varlen_plain(
        _t(packed), _t(flat), _t(lens.astype(np.int32)), *PARAMS, offsets=_t(offsets)
    )
    np.testing.assert_array_equal(got.numpy(), whole.reshape(len(refs), -1)[:, start].numpy())
    want = np.asarray(
        score_grid(
            jax_encode_batch(reads, 70, JAX_READ_PAD), jax_encode_batch(refs, 240, JAX_REF_PAD), *(np.int32(p) for p in PARAMS)
        )
    ).T
    np.testing.assert_array_equal(got.numpy(), want)
    assert got[0, 0] == 5 * 50  # the planted read aligns fully across the edges


def test_band_wrapper_takes_plain_path_on_cpu_only():
    cuda_score.reset_launches()
    packed, _ = pack_reads(["ACGT", "GG"], 128)
    bnd = np.zeros((1,) + packed.shape, np.int32)
    _band(packed, ["ACGTAC"], [6], bnd)
    assert cuda_score.LAUNCHES["band_lane_best"] == 0
    with pytest.raises(ValueError):  # bnd of the wrong shape
        _band(packed, ["ACGTAC"], [6], bnd[:, :1])
    with pytest.raises(ValueError):  # ns of the wrong type
        flat = torch.from_numpy(np.frombuffer(b"ACGTAC", np.uint8).copy())
        cuda_score.band_lane_best(
            _t(packed), flat, torch.zeros(1, dtype=torch.int64), torch.tensor([6], dtype=torch.int32),
            torch.tensor([6], dtype=torch.int64), _t(bnd), *PARAMS,
        )


@pytest.mark.gpu
@pytest.mark.parametrize("params", [PARAMS, (5, -3, -20)], ids=["one_piece", "pieces"])
def test_band_kernel_matches_plain_on_card(params):
    """Both forms, each as one piece a segment and cut into column pieces
    where the plan cuts (gap -20: W = 320, so the 4 kb ref's segment of
    1,334 columns is cut), against the plain version at every start lane
    and bnd_out lane."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    dev = torch.device("cuda")
    rng = np.random.default_rng(4)
    reads = _seqs(rng, rng.integers(1, 151, size=64)) + [""]
    refs = _seqs(rng, [0, 1, 500, 2100, 4000])
    packed, start = pack_reads(reads, 256)
    flat, lens = encode_concat(refs)
    offsets = np.concatenate(([0], np.cumsum(lens)[:-1])).astype(np.int64)
    ns = np.maximum(1, -(-lens // 3)).astype(np.int32)
    bnd = rng.integers(0, 200, size=(len(refs),) + packed.shape).astype(np.int32)
    seg_lens = np.clip(lens - ns, 0, ns).astype(np.int32)
    args = [_t(a).to(dev) for a in (packed, flat, np.where(seg_lens > 0, offsets + ns, 0), seg_lens, ns, bnd)]
    p_lane, p_bout = cuda_score.band_lane_best_plain(*args, *params)
    idx = torch.from_numpy(start.astype(np.int64)).to(dev)
    assert cuda_score.k3_form(256, *params) == "s16x2"
    for form in ("s16x2", "int32"):
        for split in (True, False):
            k_lane, k_bout = cuda_score._band_lane_best(*args, *params, form=form, split=split)
            assert torch.equal(k_lane.reshape(len(refs), -1)[:, idx], p_lane.reshape(len(refs), -1)[:, idx])
            assert torch.equal(k_bout, p_bout)
    k_lane, k_bout = cuda_score.band_lane_best(*args, *params)
    assert torch.equal(k_lane.reshape(len(refs), -1)[:, idx], p_lane.reshape(len(refs), -1)[:, idx])
    assert torch.equal(k_bout, p_bout)
