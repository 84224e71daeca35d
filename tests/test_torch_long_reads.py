"""Reads longer than 1,024 bp through every scoring path of the port.

On the card such reads run through the striped forms of K1-K5 (rows of
more than ``ONE_PASS_LANES`` lanes swept in stripes with carry rows);
here, on the CPU, the wrappers take the kernels' plain versions, so
these tests hold the paths around the kernels to the JAX package: the
row widths past 1,024 lanes, the chunk and scratch planner, both
traceback branches, and ``wavefront`` pinned to the diagonal kernel.
``chip_smoke.py`` [14] holds the striped kernels to the same plain
versions on the card."""

import dataclasses

import numpy as np
import pytest
import torch

from sparksmithwaterman_tpu.config import AlignConfig as JaxAlignConfig
from sparksmithwaterman_tpu.models.aligner import SerialBackend as JaxSerialBackend
from sparksmithwaterman_tpu.models.aligner import get_backend as jax_get_backend
from sparksmithwaterman_tpu.models.pipeline import run_pipeline as jax_run_pipeline
from sparksmithwaterman_tpu_torch.config import AlignConfig
from sparksmithwaterman_tpu_torch.models import batch_backend
from sparksmithwaterman_tpu_torch.models.aligner import get_backend
from sparksmithwaterman_tpu_torch.models.batch_backend import TorchBatchBackend, ref_chunks
from sparksmithwaterman_tpu_torch.models.pipeline import run_pipeline
from sparksmithwaterman_tpu_torch.ops import cuda_score
from sparksmithwaterman_tpu_torch.parallel import SeqParallelBackend, ShardedBackend, build_mesh

torch.set_num_threads(1)

_BASES = np.array(list("ACGT"))


def _seqs(rng, lens):
    return ["".join(rng.choice(_BASES, size=int(n))) for n in lens]


def _strip(path):
    return [l for l in open(path).read().splitlines() if "Execution Time" not in l]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Reads of 1,025 and 1,100 bp (each mostly a copy of a reference) and
    six of 80-150 bp against three references of 400-1,000 bp in two
    files; the JAX package's serial report on it (the oracle, about 6 M
    cells) and its sites of every read against the 1,000 bp reference."""
    rng = np.random.default_rng(1025)
    root = tmp_path_factory.mktemp("long_reads")
    (root / "refs").mkdir()
    (root / "inputs").mkdir()
    refs = _seqs(rng, [400, 700, 1000])
    long_reads = [refs[2][:900] + _seqs(rng, [125])[0], _seqs(rng, [200])[0] + refs[2][100:1000]]
    reads = long_reads + [refs[1][300:400]] + _seqs(rng, rng.integers(80, 151, 5))
    (root / "refs" / "a.rna.fna").write_text(f">gi|1|a1\n{refs[0]}\n>gi|2|a2\n{refs[1]}\n")
    (root / "refs" / "b.rna.fna").write_text(f">gi|3|b3\n{refs[2]}\n")
    (root / "inputs" / "input1.fa").write_text("\n".join(reads) + "\n")
    cfg = JaxAlignConfig(ref_dir=str(root / "refs"), in_dir=str(root / "inputs"), out_dir=str(root / "serial"),
                         strategy="serial")
    return dict(root=root, refs=refs, reads=reads, serial=_strip(jax_run_pipeline(cfg)[0]),
                sites=JaxSerialBackend().sites_for_ref(refs[2], reads))


def _cpu_mesh(shape, names):
    return build_mesh(shape, axis_names=names, devices=["cpu"] * int(np.prod(shape)))


# name -> (AlignConfig fields, backend on the CPU or None for get_backend's)
CONFIGS = {
    "batch": (dict(strategy="batch"), None),
    "wavefront": (dict(strategy="wavefront", kernel="row"), None),
    "shard_refs": (dict(strategy="shard_refs"), lambda cfg: ShardedBackend(cfg, _cpu_mesh((2, 1), ("refs", "reads")))),
    "shard_reads": (dict(strategy="shard_reads"), lambda cfg: ShardedBackend(cfg, _cpu_mesh((1, 2), ("refs", "reads")))),
    "shard_seq": (dict(strategy="shard_seq"), lambda cfg: SeqParallelBackend(cfg, _cpu_mesh((2,), ("seq",)))),
    "unpacked": (dict(pack_reads=False), None),
    "row": (dict(kernel="row"), None),
}


@pytest.mark.parametrize("name", list(CONFIGS))
def test_report_equals_jax_serial(corpus, name):
    """Each configuration's report equals the JAX package's serial report
    apart from the time line, with rows of 2,048 lanes (packed) or reads
    of 1,152 positions (unpacked) on the scoring path."""
    kw, make = CONFIGS[name]
    root = corpus["root"]
    cfg = AlignConfig(ref_dir=str(root / "refs"), in_dir=str(root / "inputs"), out_dir=str(root / name), **kw)
    backend = make(cfg) if make else None
    assert _strip(run_pipeline(cfg, backend=backend, device="cpu")[0]) == corpus["serial"]


@pytest.mark.parametrize("windowed", [False, True], ids=["full_fill", "windowed"])
def test_traceback_branches_equal_jax_oracle(corpus, monkeypatch, windowed):
    """Both traceback branches, each forced, give every read's sites
    against the 1,000 bp reference equal to the JAX oracle's, the
    1,100 bp read's among them; the windowed branch takes K2's plain
    version at 1,104 lanes."""
    monkeypatch.setattr(batch_backend, "_FILL_BUDGET", 1 if windowed else 1 << 40)
    calls = []
    real = batch_backend.find_max_cells_batched
    monkeypatch.setattr(batch_backend, "find_max_cells_batched", lambda reads, *a, **k: calls.append(reads) or real(reads, *a, **k))
    backend = TorchBatchBackend(AlignConfig(ref_dir=".", in_dir=".", out_dir="."), "cpu")
    ref, reads = corpus["refs"][2], corpus["reads"]
    got = backend.sites_for_ref(ref, reads)
    assert got == corpus["sites"]
    assert bool(calls) == windowed
    assert max(len(site[1][1]) for site in got) > 850  # the long reads' alignments


def test_ref_chunks_plan():
    """The chunk and scratch planners: references by output budget alone
    (rows of at most 1,024 lanes), by carry budget summed over a chunk
    (longest first), a reference over the carry budget alone in its
    chunk; and the rows of such a launch split into whole blocks of four
    whose scratch fits the budget, at least one block."""
    assert ref_chunks(3, [0] * 7, 10) == [slice(0, 3), slice(3, 6), slice(6, 7)]
    assert ref_chunks(1, [10, 8, 8, 5, 1], 100, 16) == [slice(0, 1), slice(1, 3), slice(3, 5)]
    assert ref_chunks(1, [30, 8, 8], 100, 16) == [slice(0, 1), slice(1, 3)]
    assert ref_chunks(1, [5, 5, 5], 2, 100) == [slice(0, 2), slice(2, 3)]
    assert ref_chunks(1, [], 2, 100) == []
    assert cuda_score.carry_elems(1024, 5, 100) == 0
    assert cuda_score.carry_elems(1025, 5, 100) == 2 * 8 * 100
    assert cuda_score.carry_elems(2048, 5, 100, row_form=True) == 8 * 2048
    budget = cuda_score.CARRY_BUDGET
    assert cuda_score.carry_rows(10, 0) == 12  # rows of at most 1,024 lanes
    assert cuda_score.carry_rows(10, cuda_score.carry_elems(2048, 10, 10**7)) == 12  # fits
    # One 1 Mb reference against 1,100 rows: 8 M int32 a block, 33 blocks fit.
    elems = cuda_score.carry_elems(2048, 1100, 10**6)
    assert elems > budget and cuda_score.carry_rows(1100, elems) == 4 * (budget // (8 * 10**6)) == 132
    assert cuda_score.carry_elems(2048, 132, 10**6) <= budget < cuda_score.carry_elems(2048, 136, 10**6)
    # A reference of more than budget / 8 columns: one block of four rows.
    assert cuda_score.carry_rows(1100, cuda_score.carry_elems(4096, 1100, budget // 4)) == 4
    # K5's column per read: 16,384-position reads x 64 refs.
    elems = 64 * cuda_score.carry_elems(16384, 1000, 0, row_form=True)
    part = cuda_score.carry_rows(1000, elems)
    assert part % 4 == 0 and 64 * cuda_score.carry_elems(16384, part, 0, row_form=True) <= budget
    assert 64 * cuda_score.carry_elems(16384, part + 4, 0, row_form=True) > budget


def test_batch_path_splits_wide_packs_by_carry(corpus, monkeypatch):
    """A small carry budget gives one K1 call per reference on 2,048-lane
    rows, each told its references' length on the host; totals equal
    those of one call for all references."""
    refs, reads = corpus["refs"], corpus["reads"]
    want = TorchBatchBackend(AlignConfig(ref_dir=".", in_dir=".", out_dir="."), "cpu").totals(reads, refs)
    monkeypatch.setattr(cuda_score, "CARRY_BUDGET", 1)
    calls = []
    real = batch_backend.lane_best_packed_varlen
    monkeypatch.setattr(batch_backend, "lane_best_packed_varlen",
                        lambda packed, *a, **k: calls.append((packed.shape, k["carry_cols"])) or real(packed, *a, **k))
    backend = TorchBatchBackend(AlignConfig(ref_dir=".", in_dir=".", out_dir="."), "cpu")
    np.testing.assert_array_equal(backend.totals(reads, refs), want)
    assert len(calls) == len(refs) and all(shape[1] == 2048 for shape, _ in calls)
    assert sorted(cols for _, cols in calls) == sorted(map(len, refs))


def test_wavefront_pins_diag_kernel():
    """``wavefront`` runs ``kernel='diag'`` whatever the config gives, and
    ``batch`` keeps its kernel, as the JAX package's ``get_backend``."""
    for strategy in ("wavefront", "batch"):
        for kernel in ("row", "diag"):
            kw = dict(ref_dir=".", in_dir=".", out_dir=".", strategy=strategy, kernel=kernel)
            want = jax_get_backend(JaxAlignConfig(**kw)).kernel
            assert get_backend(AlignConfig(**kw), device="cpu").kernel == want, (strategy, kernel)
    assert get_backend(AlignConfig(ref_dir=".", in_dir=".", out_dir=".", strategy="wavefront", kernel="row"),
                       device="cpu").pack
