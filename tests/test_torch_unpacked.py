"""The unpacked and row-form scoring paths against the JAX package on the
CPU: K4's and K5's plain versions against the Pallas kernels they replace
(interpret mode, ``tests/test_pallas.py``'s shapes), ``lane_best_packed``
in each TPU window mode, and ``TorchBatchBackend`` and ``run_pipeline``
with ``pack_reads=False`` and ``kernel='row'``.  Tolerance 0 throughout:
scores are integers."""

import dataclasses

import numpy as np
import pytest
import torch

from sparksmithwaterman_tpu.config import AlignConfig as JaxAlignConfig
from sparksmithwaterman_tpu.io.fasta import READ_PAD, REF_PAD, encode_batch
from sparksmithwaterman_tpu.models.batch_backend import BatchBackend
from sparksmithwaterman_tpu.models.pipeline import run_pipeline as jax_run_pipeline
from sparksmithwaterman_tpu.ops import packing as jax_packing
from sparksmithwaterman_tpu.ops.pallas_score import (
    pallas_lane_best_packed,
    pallas_score_grid,
    pallas_score_grid_diag,
    pallas_score_grid_diag_chunked,
)
from sparksmithwaterman_tpu_torch.config import AlignConfig
from sparksmithwaterman_tpu_torch.models.batch_backend import TorchBatchBackend
from sparksmithwaterman_tpu_torch.models.pipeline import run_pipeline
from sparksmithwaterman_tpu_torch.ops import cuda_score
from sparksmithwaterman_tpu_torch.ops.packing import pack_reads, read_best

torch.set_num_threads(1)

PARAMS = (5, -3, -4)
_BASES = np.array(list("ACGT"))
CONFIGS = [dict(pack_reads=False), dict(kernel="row")]
CONFIG_IDS = ["unpacked", "row"]


def _seqs(rng, lens):
    return ["".join(rng.choice(_BASES, size=int(l))) for l in lens]


def _grid_inputs(n_pad, ref_lens):
    """Ragged reads (one empty) and refs padded on both axes."""
    rng = np.random.default_rng(n_pad)
    reads = _seqs(rng, rng.integers(1, 24, 7)) + [""]
    refs = _seqs(rng, ref_lens)
    return encode_batch(reads, 24, READ_PAD), encode_batch(refs, n_pad, REF_PAD)


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("form", ["whole", "chunked", "carry"])
def test_score_grid_diag_matches_pallas(form):
    """K4's contract (any window mode, any state dtype) against
    ``pallas_score_grid_diag`` (whole table and carried column) and
    ``pallas_score_grid_diag_chunked``."""
    if form == "chunked":
        reads_enc, refs_enc = _grid_inputs(300, [80, 300, 177])
        want = pallas_score_grid_diag_chunked(
            reads_enc, refs_enc, *PARAMS, read_block=8, chunk=64, unroll=4, interpret=True
        )
    else:
        reads_enc, refs_enc = _grid_inputs(60, [4, 60, 33])
        mode = "carry" if form == "carry" else "auto"
        want = pallas_score_grid_diag(
            reads_enc, refs_enc, *PARAMS, read_block=8, window_mode=mode, unroll=8, interpret=True
        )
    want = np.asarray(want)
    reads_t, refs_t = _t(reads_enc, refs_enc)
    np.testing.assert_array_equal(cuda_score.score_grid_diag_plain(reads_t, refs_t, *PARAMS).numpy(), want)
    for state_dtype in ("auto", "int32", "int16"):
        got = cuda_score.score_grid_diag(
            reads_t, refs_t, *PARAMS, state_dtype=state_dtype, window_mode="carry" if form == "carry" else "auto"
        )
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)


def test_score_grid_row_matches_pallas_and_diag():
    reads_enc, refs_enc = _grid_inputs(64, [50, 64, 12])
    want = np.asarray(pallas_score_grid(reads_enc, refs_enc, *PARAMS, read_block=8, interpret=True))
    reads_t, refs_t = _t(reads_enc, refs_enc)
    got = cuda_score.score_grid_row(reads_t, refs_t, *PARAMS)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(cuda_score.score_grid_diag(reads_t, refs_t, *PARAMS).numpy(), want)


@pytest.mark.parametrize("mode", ["whole", "chunked", "stream", "carry"])
def test_lane_best_packed_matches_pallas_modes(mode):
    """K1 with every length N against ``pallas_lane_best_packed`` in each
    window mode, at the start lanes (the contract)."""
    rng = np.random.default_rng(7)
    reads = _seqs(rng, rng.integers(1, 60, 21)) + [""]
    refs_enc = encode_batch(_seqs(rng, rng.integers(20, 100, 5)), 128, REF_PAD)
    packed, start = pack_reads(reads, 64)
    lane = pallas_lane_best_packed(packed, refs_enc, *PARAMS, read_block=8, mode=mode, unroll=8, interpret=True)
    got = cuda_score.lane_best_packed(*_t(packed, refs_enc), *PARAMS, mode=mode)
    np.testing.assert_array_equal(read_best(got, start).numpy(), np.asarray(jax_packing.read_best(lane, start)))


def test_options_are_checked_and_cpu_counts_no_launch():
    """The wrappers' and the config's option checks, and no launch counted
    for CPU tensors."""
    assert AlignConfig(ref_dir=".", in_dir=".", out_dir=".", kernel="row").kernel == "row"
    with pytest.raises(ValueError):
        AlignConfig(ref_dir=".", in_dir=".", out_dir=".", kernel="prefix")
    cuda_score.reset_launches()
    reads_t, refs_t = _t(*_grid_inputs(60, [60]))
    packed, _ = pack_reads(["ACGT"], 64)
    cuda_score.score_grid_diag(reads_t, refs_t, *PARAMS)
    cuda_score.score_grid_row(reads_t, refs_t, *PARAMS)
    cuda_score.lane_best_packed(torch.from_numpy(packed), refs_t, *PARAMS, mode="stream")
    assert all(count == 0 for count in cuda_score.LAUNCHES.values())
    for bad in (dict(state_dtype="int8"), dict(window_mode="whole")):
        with pytest.raises(ValueError):
            cuda_score.score_grid_diag(reads_t, refs_t, *PARAMS, **bad)
    with pytest.raises(ValueError):
        cuda_score.lane_best_packed(torch.from_numpy(packed), refs_t, *PARAMS, mode="table")
    with pytest.raises(ValueError):
        cuda_score.score_grid_row(reads_t.to(torch.int32), refs_t, *PARAMS)
    empty = cuda_score.score_grid_row(reads_t[:, :0], refs_t, *PARAMS)
    assert empty.shape == (reads_t.shape[0], 1) and not empty.any()


def _config(cls, **kw):
    return cls(ref_dir=".", in_dir=".", out_dir=".", read_bucket=8, ref_bucket=8, **kw)


@pytest.mark.parametrize("kw", CONFIGS, ids=CONFIG_IDS)
def test_backend_matches_jax(kw, monkeypatch):
    """totals, best_of and sites_for_ref against the JAX BatchBackend on the
    same config, through several reference groups and chunks (a small
    output budget)."""
    from sparksmithwaterman_tpu_torch.models import batch_backend

    monkeypatch.setattr(batch_backend, "_OUT_BUDGET", 2 * 12)
    rng = np.random.default_rng(len(kw) + 31)
    reads = _seqs(rng, rng.integers(0, 40, 11)) + [""]
    refs = _seqs(rng, [0, 1, 9, 30, 64, 100, 150, 17, 90])
    refs[6] = refs[5][:30] + refs[6][30:]
    backend = TorchBatchBackend(_config(AlignConfig, **kw), "cpu")
    jax_backend = BatchBackend(_config(JaxAlignConfig, **kw))
    np.testing.assert_array_equal(backend.totals(reads, refs), jax_backend.totals(reads, refs))
    assert backend.best_of(reads, refs) == jax_backend.best_of(reads, refs)
    for ref in refs[4:6]:
        assert backend.sites_for_ref(ref, reads) == jax_backend.sites_for_ref(ref, reads)


def _corpus(root, rng):
    (root / "refs").mkdir(parents=True)
    (root / "inputs").mkdir()
    seqs = _seqs(rng, rng.integers(1, 300, 8))
    seqs[3] = seqs[0]
    for fi, chunk in enumerate((seqs[:5], seqs[5:])):
        (root / "refs" / f"r{fi}.rna.fna").write_text(
            "\n".join(f">gi|{fi}{j}|s{fi}{j}\n{s}" for j, s in enumerate(chunk)) + "\n"
        )
    reads = _seqs(rng, rng.integers(1, 40, 6)) + [seqs[2][5:40], ""]
    (root / "inputs" / "input1.fa").write_text("\n".join(reads) + "\n")


@pytest.mark.parametrize("kw", CONFIGS, ids=CONFIG_IDS)
def test_run_pipeline_reports_match_swtpu(tmp_path, kw):
    """Report bytes, apart from the Execution Time line, equal ``swtpu``'s
    with the same config."""
    _corpus(tmp_path, np.random.default_rng(len(kw)))

    def config(tag, cls):
        return dataclasses.replace(
            _config(cls, **kw), ref_dir=str(tmp_path / "refs"), in_dir=str(tmp_path / "inputs"),
            out_dir=str(tmp_path / f"out_{tag}"),
        )

    def strip(path):
        return [l for l in open(path).read().splitlines() if "Execution Time" not in l]

    want = strip(jax_run_pipeline(config("jax", JaxAlignConfig))[0])
    assert strip(run_pipeline(config("torch", AlignConfig), device="cpu")[0]) == want
