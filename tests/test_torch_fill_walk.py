"""K9 (the fill with direction codes) and K10 (the walk) on the CPU.

``cuda_score.fill_dirs`` and ``cuda_score.trace_walk`` take their plain
versions for CPU tensors (the kernels run only on the card, where
``chip_smoke.py`` [2] holds them to those plain versions).  Here the
wrappers are held to the JAX package's ``fill_pairs`` and
``fill_and_trace`` (plain ``lax``, no Pallas) on the same encoded inputs,
in both tie orders; a model of K9's loop (tiles of 512 columns, lanes of
16, one column carried between tiles) to ``fill_pairs`` across two tile
borders; and both branches of ``sites_for_ref`` to the serial oracle,
through the wrappers, a pair past the full-fill branch's capacity
included.  Tolerance 0 throughout: scores and codes are
integers.
"""

import numpy as np
import pytest
import torch

from sparksmithwaterman_tpu.models.aligner import SerialBackend
from sparksmithwaterman_tpu.ops import device_traceback as jax_dt
from sparksmithwaterman_tpu.ops import recurrence as jax_rec
from sparksmithwaterman_tpu_torch.config import AlignConfig
from sparksmithwaterman_tpu_torch.io.fasta import READ_PAD, REF_PAD, encode_batch
from sparksmithwaterman_tpu_torch.models import batch_backend
from sparksmithwaterman_tpu_torch.ops import cuda_score, device_traceback, longseq, traceback
from sparksmithwaterman_tpu_torch.ops.recurrence import fill_pairs

torch.set_num_threads(1)

PARAMS = (5, -3, -4)
_BASES = np.array(list("ACGT"))
TIES = ("serial", "distributed")


def _seqs(rng, lens):
    return ["".join(rng.choice(_BASES, size=int(n))) for n in lens]


def _windows(ref, ends, width):
    """Windows of ``width`` columns ending at each of ``ends``, left-padded
    with REF_PAD where the reference starts later, as longseq builds them."""
    out = np.full((len(ends), width), REF_PAD, np.uint8)
    for t, j in enumerate(ends):
        piece = ref[max(0, j - width) : j]
        out[t, width - len(piece) :] = encode_batch([piece], len(piece), REF_PAD)[0]
    return out


def _fill_cases():
    rng = np.random.default_rng(12)
    ref = "".join(_seqs(rng, [300]))
    reads = _seqs(rng, rng.integers(3, 24, 5)) + [ref[100:120]]
    long_ref = "".join(_seqs(rng, [1100]))
    return {
        # One reference (1, N) for every read, as the full-fill branch passes it.
        "broadcast_ref": (encode_batch(reads, 24, READ_PAD), encode_batch([ref], 304, REF_PAD), PARAMS),
        # Windows ending at max-cell columns, two of them starting before the
        # reference does (REF_PAD on the left), as the windowed branch passes them.
        "left_padded_windows": (encode_batch(reads, 24, READ_PAD), _windows(ref, [10, 40, 120, 200, 299, 300], 64),
                                PARAMS),
        "gap_minus_one": (encode_batch(reads[:3] + ["AAAA"], 24, READ_PAD),
                          encode_batch(["GGCAC" + "CCCA" * 12] * 4, 56, REF_PAD), (5, -3, -1)),
        "one_bp_read": (encode_batch(["A", "C", "G"], 1, READ_PAD), encode_batch(["ACGTA" * 8], 40, REF_PAD), PARAMS),
        # 1,100 columns: three of K9's tiles, and not a multiple of 16.
        "n_1100": (encode_batch([long_ref[490:530], long_ref[1000:1030] + "ACG"], 40, READ_PAD),
                   encode_batch([long_ref], 1100, REF_PAD), PARAMS),
        # A window of REF_PAD alone and a read of READ_PAD alone.
        "all_pad_window": (encode_batch(["ACGTACGT", ""], 8, READ_PAD),
                           np.full((2, 48), REF_PAD, np.uint8), PARAMS),
    }


@pytest.mark.parametrize("case", list(_fill_cases()))
def test_fill_dirs_matches_jax_fill_pairs(case):
    reads, refs, params = _fill_cases()[case]
    b = reads.shape[0]
    for tie in TIES:
        h_j, d_j = jax_rec.fill_pairs(
            reads, np.broadcast_to(refs, (b, refs.shape[1])).copy(), *(np.int32(p) for p in params),
            tie_semantics=tie,
        )
        h, dirs = cuda_score.fill_dirs(torch.from_numpy(reads), torch.from_numpy(refs), *params,
                                       tie_semantics=tie, want_h=True)
        assert h.dtype == torch.int32 and dirs.dtype == torch.int8
        assert dirs.shape == (b, reads.shape[1], refs.shape[1])
        np.testing.assert_array_equal(h.numpy(), np.asarray(h_j))
        np.testing.assert_array_equal(dirs.numpy(), np.asarray(d_j))
        none, codes = cuda_score.fill_dirs(torch.from_numpy(reads), torch.from_numpy(refs), *params,
                                           tie_semantics=tie, want_h=False)
        assert none is None and torch.equal(codes, dirs)
    if case == "all_pad_window":
        assert not dirs.any()
    else:
        assert {1, 2, 3} <= set(np.unique(dirs.numpy())) or case == "one_bp_read"


@pytest.mark.parametrize("tie", TIES)
def test_trace_walk_matches_jax_fill_and_trace(tie):
    """Begins and codes of every (pair, cell) walk equal the JAX package's,
    cells of -1 (capacity above the pair's max cells) and walks cut by the
    cap included."""
    rng = np.random.default_rng(29)
    reads = _seqs(rng, rng.integers(1, 30, size=6)) + ["ACGTACGT", "AAAA", ""]
    refs = _seqs(rng, rng.integers(10, 90, size=6)) + ["TTACGTACGTAATTACGTACGTAA", "AAAAAAA", "ACGT"]
    reads_enc = encode_batch(reads, 32, READ_PAD)
    refs_enc = encode_batch(refs, 96, REF_PAD)
    _, dirs = cuda_score.fill_dirs(torch.from_numpy(reads_enc), torch.from_numpy(refs_enc), *PARAMS,
                                   tie_semantics=tie, want_h=False)
    for cap in (device_traceback.path_cap(32, 5, -4), 5):
        _, counts, cells, begins, codes = (np.array(t) for t in jax_dt.fill_and_trace(
            reads_enc, refs_enc, *(np.int32(p) for p in PARAMS), capacity=8, cap=cap, tie_semantics=tie,
        ))
        assert (cells == -1).any() and (counts > 1).any()
        got_b, got_c = cuda_score.trace_walk(dirs, torch.from_numpy(cells), cap)
        assert got_b.dtype == torch.int32 and got_c.dtype == torch.int8
        np.testing.assert_array_equal(got_b.numpy(), begins)
        np.testing.assert_array_equal(got_c.numpy(), codes)
        np.testing.assert_array_equal(got_b.numpy()[cells[..., 0] < 0], 0)
        if cap == 5:
            assert (codes[..., -1] != 0).any()  # some walk is cut by the cap


def _tile_model(reads_u8, refs_u8, match, mismatch, gap, tie, tile=512, cols=16):
    """K9's loop (csrc/fill_dirs.cu) in torch: tiles of ``tile`` columns,
    all rows of a tile before the next; a row's A[k] - gap*k in lanes of
    ``cols`` columns, its prefix max within each lane, then across the
    lanes (the warp's scan), the carried column entering as column base - 1;
    between tiles each row carries west = H[i][base-1], and the row before
    above = H[i-1][base-1]."""
    b, m = reads_u8.shape
    n = refs_u8.shape[1]
    lanes = tile // cols
    reads_i = reads_u8.to(torch.int32)
    refs_i = refs_u8.to(torch.int32).expand(b, n)
    h_all = torch.zeros((b, m, n), dtype=torch.int32)
    d_all = torch.zeros((b, m, n), dtype=torch.int8)
    carry = torch.zeros((b, m), dtype=torch.int32)
    ramp = gap * torch.arange(tile, dtype=torch.int32)
    for base in range(0, n, tile):
        width = min(tile, n - base)
        rf = torch.full((b, tile), REF_PAD, dtype=torch.int32)
        rf[:, :width] = refs_i[:, base : base + width]
        h = torch.zeros((b, tile), dtype=torch.int32)
        above = torch.zeros(b, dtype=torch.int32)
        for i in range(m):
            west = carry[:, i].clone() if base else torch.zeros(b, dtype=torch.int32)
            hp = h
            nw = torch.cat([above[:, None], hp[:, :-1]], dim=1)
            a = nw + torch.where(rf == reads_i[:, i : i + 1], match, mismatch)
            ins = hp + gap
            lane_run = torch.cummax((torch.clamp_min(torch.maximum(a, ins), 0) - ramp).reshape(b, lanes, cols),
                                    dim=2).values
            warp = torch.cummax(lane_run[:, :, -1], dim=1).values
            before = torch.maximum(torch.cat([warp[:, :1], warp[:, :-1]], dim=1), (west + gap)[:, None])
            before[:, 0] = west + gap
            h = torch.maximum(lane_run, before[:, :, None]).reshape(b, tile) + ramp
            d = torch.cat([west[:, None], h[:, :-1]], dim=1) + gap
            order = ((a, 1), (ins, 2), (d, 3)) if tie == "serial" else ((d, 3), (ins, 2), (a, 1))
            code = torch.zeros_like(h)
            for cand, c in reversed(order):
                code = torch.where(cand == h, c, code)
            h_all[:, i, base : base + width] = h[:, :width]
            d_all[:, i, base : base + width] = torch.where(h > 0, code, 0)[:, :width].to(torch.int8)
            above = west
            if base + tile < n:
                carry[:, i] = h[:, -1]
    return h_all, d_all


def test_tile_model_of_k9_matches_fill_pairs():
    """Across K9's tile borders at columns 512 and 1,024 of a 1,100-column
    reference: reads that align across each border, one with a run of
    reference gaps over column 512 (its deletion codes come from `west`),
    one with a read gap, and a random one; both tie orders."""
    rng = np.random.default_rng(40)
    ref = "".join(_seqs(rng, [1100]))
    reads = [ref[495:511] + ref[515:532], ref[1010:1020] + "T" + ref[1020:1040], ref[480:540],
             "".join(_seqs(rng, [30]))]
    reads_t = torch.from_numpy(encode_batch(reads, 64, READ_PAD))
    ref_t = torch.from_numpy(encode_batch([ref], 1100, REF_PAD))
    for tie in TIES:
        want_h, want_d = fill_pairs(reads_t, ref_t, *PARAMS, tie_semantics=tie)
        h, d = _tile_model(reads_t, ref_t, *PARAMS, tie)
        assert torch.equal(h, want_h) and torch.equal(d, want_d)
        assert (want_d[0, :, 511:516] == 3).any() and (want_d[:, :, 1020:1030] > 0).any()


def _spy(monkeypatch, module, name, calls):
    fn = getattr(module, name)

    def spy(*args, **kwargs):
        calls.append((module.__name__.rsplit(".", 1)[1], name, kwargs.get("capacity")))
        return fn(*args, **kwargs)

    monkeypatch.setattr(module, name, spy)


@pytest.mark.parametrize("windowed", [False, True], ids=["full_fill", "windowed"])
def test_sites_for_ref_goes_through_the_wrappers(monkeypatch, windowed):
    """The full-fill branch fills, lists and walks through fill_list, the
    windowed branch through fill_walk, and both give the serial oracle's
    sites.  "CA" has more max cells than the full-fill branch's first
    listing holds (64): that branch fills, lists and walks it again at its
    own count through the same wrapper, and never reaches the host walk
    (sites_from_fill)."""
    calls = []
    for module, name in ((device_traceback, "fill_list"), (longseq, "fill_walk")):
        _spy(monkeypatch, module, name, calls)

    def host_walk(*args, **kwargs):
        raise AssertionError("sites_for_ref reached the host walk")

    monkeypatch.setattr(traceback, "sites_from_fill", host_walk)
    if windowed:
        monkeypatch.setattr(batch_backend, "_FILL_BUDGET", 1)
    rng = np.random.default_rng(42)
    ref = "".join(_seqs(rng, [150])) + "AAAAAAAA" + "".join(_seqs(rng, [60])) + "CA" * 70
    reads = _seqs(rng, rng.integers(1, 25, size=7)) + ["", ref[50:70], "AAAA", "CA"]
    config = AlignConfig(ref_dir=".", in_dir=".", out_dir=".", read_bucket=32, ref_bucket=64)
    backend = batch_backend.TorchBatchBackend(config, "cpu")
    assert backend._windowed(ref, reads) == windowed
    got = backend.sites_for_ref(ref, reads)
    assert got == SerialBackend().sites_for_ref(ref, reads)
    assert sum(1 for s in got if s[1] == ("CA", "CA")) > batch_backend._TRACE_CAPACITY
    kinds = {c[:2] for c in calls}
    if windowed:
        assert {("longseq", "fill_walk")} == kinds
    else:
        assert {("device_traceback", "fill_list")} == kinds
        listed = [c[2] for c in calls]
        assert listed[0] == batch_backend._TRACE_CAPACITY and max(listed) > batch_backend._TRACE_CAPACITY


def test_wrappers_refuse_malformed_inputs():
    reads = torch.zeros((3, 4), dtype=torch.uint8)
    refs = torch.ones((3, 9), dtype=torch.uint8)
    for bad in (dict(reads_u8=reads.to(torch.int32)), dict(refs_u8=refs[:2]), dict(tie_semantics="last"),
                dict(refs_u8=refs[0])):
        kw = {**dict(reads_u8=reads, refs_u8=refs, tie_semantics="serial"), **bad}
        with pytest.raises(ValueError):
            cuda_score.fill_dirs(kw.pop("reads_u8"), kw.pop("refs_u8"), *PARAMS, want_h=True, **kw)
    _, dirs = cuda_score.fill_dirs(reads, refs[:1], *PARAMS, tie_semantics="serial", want_h=False)
    cells = torch.full((3, 2, 2), -1, dtype=torch.int32)
    for args in ((dirs.to(torch.int32), cells, 4), (dirs, cells[:2], 4), (dirs, cells.to(torch.int64), 4),
                 (dirs, cells, -1)):
        with pytest.raises(ValueError):
            cuda_score.trace_walk(*args)
    begins, codes = cuda_score.trace_walk(dirs, cells, 4)
    assert not begins.any() and codes.shape == (3, 2, 4) and not codes.any()
