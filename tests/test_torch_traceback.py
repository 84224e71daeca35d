"""The port's traceback branches against the JAX package's and the oracle.

Normal branch: ``fill_and_trace`` (batched fill with directions, row-major
max cells up to a capacity, lock-step walks).  Windowed branch:
``find_max_cells_batched`` (one argmax pass, in-lane-tie fallback) and
``sites_for_ref_long_batched`` (window fills and walks).  The JAX side
runs its CPU path (``backend='scan'``).  Where the JAX package is known
to be wrong (bounds hard-wired to the default scores), the port is held
to ``core.oracle`` instead.
"""

import numpy as np
import pytest
import torch

from sparksmithwaterman_tpu.config import ScoringScheme as JaxScoringScheme
from sparksmithwaterman_tpu.core import oracle
from sparksmithwaterman_tpu.io.fasta import READ_PAD, REF_PAD, encode_batch
from sparksmithwaterman_tpu.models.aligner import SerialBackend
from sparksmithwaterman_tpu.ops import device_traceback as jax_dt
from sparksmithwaterman_tpu.ops import longseq as jax_longseq
from sparksmithwaterman_tpu_torch.config import AlignConfig, ScoringScheme
from sparksmithwaterman_tpu_torch.models import batch_backend
from sparksmithwaterman_tpu_torch.ops import device_traceback as torch_dt
from sparksmithwaterman_tpu_torch.ops import longseq as torch_longseq

torch.set_num_threads(1)

PARAMS = (5, -3, -4)
_BASES = np.array(list("ACGT"))


def _seqs(rng, lens):
    return ["".join(rng.choice(_BASES, size=int(l))) for l in lens]


@pytest.mark.parametrize("m", [1, 8, 24, 150, 256])
def test_bounds_equal_jax_at_default_scheme(m):
    assert torch_dt.path_cap(m, 5, -4) == jax_dt.path_cap(m)
    for n in (10, 100, 5000):
        assert torch_longseq.window_width(m, n, *PARAMS) == jax_longseq.window_width(m, n)


@pytest.mark.parametrize("tie_semantics", ["serial", "distributed"])
@pytest.mark.parametrize("capacity", [64, 3])
def test_fill_and_trace_matches_jax(tie_semantics, capacity):
    rng = np.random.default_rng(17)
    reads = _seqs(rng, rng.integers(1, 30, size=6)) + ["ACGTACGT", "AAAA", ""]
    refs = _seqs(rng, rng.integers(10, 90, size=6)) + ["TTACGTACGTAATTACGTACGTAA", "CCCCCC", "ACGT"]
    reads_enc = encode_batch(reads, 32, READ_PAD)
    refs_enc = encode_batch(refs, 96, REF_PAD)
    cap = torch_dt.path_cap(32, 5, -4)
    got = torch_dt.fill_and_trace(
        torch.from_numpy(reads_enc), torch.from_numpy(refs_enc), *PARAMS,
        capacity=capacity, cap=cap, tie_semantics=tie_semantics,
    )
    want = jax_dt.fill_and_trace(
        reads_enc, refs_enc, *(np.int32(p) for p in PARAMS),
        capacity=capacity, cap=cap, tie_semantics=tie_semantics,
    )
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    best, counts, cells, begins, codes = (t.numpy() for t in got)
    for k in range(len(reads)):
        if counts[k] > capacity and best[k] > 0:
            continue
        sites = torch_dt.sites_from_trace(
            int(best[k]), int(counts[k]), cells[k], begins[k], codes[k], refs[k], reads[k]
        )
        assert sites == oracle.opt_alignments(refs[k], reads[k], tie_semantics=tie_semantics)[1]


def _windowed_case():
    rng = np.random.default_rng(23)
    ref = "".join(_seqs(rng, [400]))
    # random reads; planted copies that tie inside one DP row
    reads = _seqs(rng, rng.integers(5, 40, size=6)) + [ref[40:60], ref[40:52] + ref[40:52][:2], "ACGT"]
    ref = ref[:200] + ref[40:60] + ref[200:]
    return reads, ref


def test_find_max_cells_batched_matches_jax_and_oracle():
    reads, ref = _windowed_case()
    got = torch_longseq.find_max_cells_batched(reads, ref, PARAMS, device="cpu")
    want = jax_longseq.find_max_cells_batched(reads, ref, tuple(np.int32(p) for p in PARAMS), backend="scan")
    for read, (gb, gc), (wb, wc) in zip(reads, got, want):
        assert gb == wb
        np.testing.assert_array_equal(gc.reshape(-1, 2), np.asarray(wc).reshape(-1, 2))
        _, _, best, cells = oracle.fill_matrices(ref, read)
        assert gb == best
        if best > 0:
            assert [(i + 1, j + 1) for i, j in gc.tolist()] == cells
    # The single-pair form agrees too.
    for read in reads[-3:]:
        best, cells = torch_longseq.find_max_cells(read, ref, PARAMS, device="cpu")
        want_best, want_cells = jax_longseq.find_max_cells(read, ref, tuple(np.int32(p) for p in PARAMS))
        assert best == want_best
        np.testing.assert_array_equal(cells, np.asarray(want_cells))
    # An empty read scores 0 with no cells (the JAX scan path takes no
    # empty reads).
    best, cells = torch_longseq.find_max_cells_batched(["", reads[0]], ref, PARAMS, device="cpu")[0]
    assert best == 0 and cells.shape == (0, 2)


@pytest.mark.parametrize("tie_semantics", ["serial", "distributed"])
def test_sites_for_ref_long_batched_matches_jax_and_oracle(tie_semantics):
    reads, ref = _windowed_case()
    cells = torch_longseq.find_max_cells_batched(reads, ref, PARAMS, device="cpu")
    got = torch_longseq.sites_for_ref_long_batched(
        ref, reads, PARAMS, ref_bucket=64, cell_lists=cells, tie_semantics=tie_semantics, device="cpu"
    )
    want = jax_longseq.sites_for_ref_long_batched(
        ref, reads, tuple(np.int32(p) for p in PARAMS), ref_bucket=64,
        cell_lists=cells, tie_semantics=tie_semantics,
    )
    assert got == want
    for read, sites in zip(reads, got):
        assert sites == oracle.opt_alignments(ref, read, tie_semantics=tie_semantics)[1]


def test_gap_minus_one_matches_oracle_in_both_branches(monkeypatch):
    """With gap = -1 an optimal path can be much wider and longer than
    the default scheme's bounds (8m/3 + 2 columns, 4m steps): here six
    matches separated by four deletions each span 26 columns and take
    26 steps for a 6 bp read.  Held to the oracle, not the JAX package,
    whose bounds assume the default scheme."""
    scoring = ScoringScheme(gap=-1)
    jax_scoring = JaxScoringScheme(gap=-1)
    params = (scoring.match, scoring.mismatch, scoring.gap)
    read = "A" * 8
    ref = "GG" + "CCCC".join(read) + "GG"
    reads = [read, "CCCAAA"]
    want = SerialBackend(jax_scoring).sites_for_ref(ref, reads)
    assert max(len(s[1][0]) for s in want) == 36

    cells = torch_longseq.find_max_cells_batched(reads, ref, params, device="cpu")
    per_read = torch_longseq.sites_for_ref_long_batched(ref, reads, params, ref_bucket=8, cell_lists=cells, device="cpu")
    for r, sites in zip(reads, per_read):
        assert sites == oracle.opt_alignments(ref, r, jax_scoring)[1]

    config = AlignConfig(ref_dir=".", in_dir=".", out_dir=".", scoring=scoring, read_bucket=8, ref_bucket=8)
    backend = batch_backend.TorchBatchBackend(config, "cpu")
    assert not backend._windowed(ref, reads)
    assert backend.sites_for_ref(ref, reads) == want
    monkeypatch.setattr(batch_backend, "_WINDOW_READS", 1)
    assert backend._windowed(ref, reads)
    assert backend.sites_for_ref(ref, reads) == want


@pytest.mark.parametrize("windowed", [False, True], ids=["full_fill", "windowed"])
def test_backend_sites_for_ref_matches_oracle(monkeypatch, windowed):
    if windowed:
        monkeypatch.setattr(batch_backend, "_FILL_BUDGET", 1)
    rng = np.random.default_rng(42)
    reads = _seqs(rng, rng.integers(1, 25, size=9)) + [""]
    ref = "".join(_seqs(rng, [200]))
    reads.append(ref[50:70])
    config = AlignConfig(ref_dir=".", in_dir=".", out_dir=".", read_bucket=32, ref_bucket=64)
    backend = batch_backend.TorchBatchBackend(config, "cpu")
    assert backend._windowed(ref, reads) == windowed
    assert backend.sites_for_ref(ref, reads) == SerialBackend().sites_for_ref(ref, reads)
