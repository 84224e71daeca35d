"""The port's mesh strategies against the JAX package on the CPU: the
striped and band rings of ``shard_seq``, ``SeqParallelBackend``,
``ShardedBackend`` (``shard_refs``, ``shard_reads``, a rectangular mesh)
and whole-pipeline report bytes.  A port mesh of N CPU entries stands
where the JAX tests use N of their 8 virtual devices."""

import dataclasses

import numpy as np
import pytest
import torch

from sparksmithwaterman_tpu.config import AlignConfig as JaxAlignConfig
from sparksmithwaterman_tpu.io.fasta import READ_PAD, REF_PAD, encode_batch
from sparksmithwaterman_tpu.models.aligner import SerialBackend
from sparksmithwaterman_tpu.models.pipeline import run_pipeline as jax_run_pipeline
from sparksmithwaterman_tpu.parallel import ShardedBackend as JaxShardedBackend
from sparksmithwaterman_tpu.parallel import SeqParallelBackend as JaxSeqParallelBackend
from sparksmithwaterman_tpu.parallel import build_mesh as jax_build_mesh
from sparksmithwaterman_tpu.parallel import seqparallel as jax_sp
from sparksmithwaterman_tpu_torch.config import AlignConfig
from sparksmithwaterman_tpu_torch.models.pipeline import run_pipeline
from sparksmithwaterman_tpu_torch.parallel import ShardedBackend, SeqParallelBackend, build_mesh, engine
from sparksmithwaterman_tpu_torch.parallel import seqparallel as sp

torch.set_num_threads(1)

PARAMS = (5, -3, -4)
_BASES = np.array(list("ACGT"))


def _seqs(rng, lens):
    return ["".join(rng.choice(_BASES, size=int(l))) for l in lens]


def _cpu_mesh(shape, names):
    return build_mesh(shape, axis_names=names, devices=["cpu"] * int(np.prod(shape)))


def _config(cls=AlignConfig, **kw):
    return cls(ref_dir=".", in_dir=".", out_dir=".", read_bucket=8, ref_bucket=8, **kw)


@pytest.mark.parametrize("size", [1, 2, 4, 8])
def test_striped_ring_matches_jax(size):
    """``seqparallel_scores`` (strings, a ref not divisible by the mesh
    size, a read straddling segment edges) and ``seqparallel_scores_batch``
    (encoded, an empty read and an all-pad tail row) against the JAX
    functions on as many of their virtual devices."""
    rng = np.random.default_rng(size)
    mesh, jax_mesh = _cpu_mesh((size,), ("seq",)), jax_build_mesh((size,), axis_names=("seq",), n_devices=size)
    ref = _seqs(rng, [199])[0]
    reads = _seqs(rng, rng.integers(5, 30, 5)) + [ref[30:75]]
    got = sp.seqparallel_scores(reads, ref, *PARAMS, mesh=mesh, stripe=4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_sp.seqparallel_scores(reads, ref, *PARAMS, mesh=jax_mesh, stripe=4)))
    assert got[-1] == 5 * 45
    reads_enc = encode_batch(_seqs(rng, [12] * 5) + [""], 16, READ_PAD)
    refs_enc = encode_batch(_seqs(rng, [40, 37, 24]) + [""], 40, REF_PAD)
    got = sp.seqparallel_scores_batch(reads_enc, refs_enc, *PARAMS, mesh=mesh, stripe=8)
    want = jax_sp.seqparallel_scores_batch(reads_enc, refs_enc, *PARAMS, mesh=jax_mesh, stripe=8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got[3] == 0).all()


def test_seqparallel_scores_band_matches_jax():
    """The band ring (K3's plain version per segment) against the JAX
    band ring in interpret mode, at one tiny shape on a 2-entry mesh."""
    rng = np.random.default_rng(41)
    base = _seqs(rng, [120])[0]
    reads = _seqs(rng, rng.integers(5, 40, 4)) + [base[35:85]]
    refs_enc = encode_batch([base, _seqs(rng, [77])[0], ""], 120, REF_PAD)
    got = sp.seqparallel_scores_band(reads, refs_enc, *PARAMS, mesh=_cpu_mesh((2,), ("seq",)))
    want = jax_sp.seqparallel_scores_band(
        reads, refs_enc, *PARAMS, mesh=jax_build_mesh((2,), axis_names=("seq",), n_devices=2), unroll=8, interpret=True
    )
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got[0, -1] == 5 * 50


def test_seq_backend_totals_match_jax_and_serial(monkeypatch):
    """The band ring with several chunks per segment partition (a small
    output budget), on a 3-entry mesh."""
    monkeypatch.setattr(sp, "_OUT_BUDGET", 2 * 128 * 8)
    rng = np.random.default_rng(7)
    reads = _seqs(rng, rng.integers(1, 15, 9)) + [""]
    refs = _seqs(rng, [30, 64, 17, 90, 33, 9, 120, 56, 41, 0, 2])
    refs[5] = refs[1]  # a tie
    want = SerialBackend().totals(reads, refs)
    np.testing.assert_array_equal(JaxSeqParallelBackend(_config(JaxAlignConfig, strategy="shard_seq")).totals(reads, refs), want)
    backend = SeqParallelBackend(_config(strategy="shard_seq"), _cpu_mesh((3,), ("seq",)))
    np.testing.assert_array_equal(backend.totals(reads, refs), want)
    assert backend.best_of(reads, refs) == SerialBackend().best_of(reads, refs)


@pytest.mark.parametrize("shape", [(8, 1), (1, 8), (4, 2)], ids=["shard_refs", "shard_reads", "4x2"])
def test_sharded_backend_matches_jax(shape, monkeypatch):
    """Several packs (a small int32 budget) and K1 chunks (a small output
    budget); every mesh entry with rows to score gets K1 calls."""
    monkeypatch.setattr(engine, "_INT32_SAFE", 5 * 150)
    monkeypatch.setattr(engine, "_OUT_BUDGET", 3 * 8 * 128)
    calls = []
    real = engine.lane_best_packed_varlen
    monkeypatch.setattr(engine, "lane_best_packed_varlen", lambda packed, *a, **k: calls.append(packed.shape) or real(packed, *a, **k))
    rng = np.random.default_rng(sum(shape))
    reads = _seqs(rng, rng.integers(1, 60, 13)) + [""]
    refs = _seqs(rng, rng.integers(0, 80, 7))
    strategy = "shard_reads" if shape == (1, 8) else "shard_refs"
    jax_backend = JaxShardedBackend(_config(JaxAlignConfig, strategy=strategy), jax_build_mesh(shape))
    backend = ShardedBackend(_config(strategy=strategy), _cpu_mesh(shape, ("refs", "reads")))
    np.testing.assert_array_equal(backend.totals(reads, refs), jax_backend.totals(reads, refs))
    np.testing.assert_array_equal(backend.totals(reads, refs), SerialBackend().totals(reads, refs))
    assert backend.best_of(reads, refs) == jax_backend.best_of(reads, refs)
    assert len(calls) >= 3 * min(shape[0], len(refs))


def _corpus(root, rng):
    (root / "refs").mkdir(parents=True)
    (root / "inputs").mkdir()
    seqs = _seqs(rng, rng.integers(1, 150, 7))
    seqs[3] = seqs[0]
    for fi, chunk in enumerate((seqs[:4], seqs[4:])):
        (root / "refs" / f"r{fi}.rna.fna").write_text("\n".join(f">gi|{fi}{j}|s{fi}{j}\n{s}" for j, s in enumerate(chunk)) + "\n")
    (root / "inputs" / "input1.fa").write_text("\n".join(_seqs(rng, rng.integers(1, 40, 6)) + [seqs[2][5:40]]) + "\n")


def _strip(path):
    return [l for l in open(path).read().splitlines() if "Execution Time" not in l]


@pytest.mark.parametrize("strategy", ["shard_seq", "shard_refs", "shard_reads"])
def test_run_pipeline_reports_match_swtpu(tmp_path, strategy):
    """Report bytes, apart from the time line, equal ``swtpu``'s with the
    same strategy: the port on a mesh of CPU entries (3 segments, or a
    (2, 2) mesh) and on its default one-entry CPU mesh."""
    _corpus(tmp_path, np.random.default_rng(len(strategy)))

    def config(tag, cls=AlignConfig):
        return dataclasses.replace(
            _config(cls, strategy=strategy), ref_dir=str(tmp_path / "refs"), in_dir=str(tmp_path / "inputs"),
            out_dir=str(tmp_path / f"out_{tag}"),
        )

    want = _strip(jax_run_pipeline(config("jax", JaxAlignConfig))[0])
    if strategy == "shard_seq":
        backend = SeqParallelBackend(config("mesh"), _cpu_mesh((3,), ("seq",)))
    else:
        backend = ShardedBackend(config("mesh"), _cpu_mesh((2, 2), ("refs", "reads")))
    assert _strip(run_pipeline(config("mesh"), backend=backend)[0]) == want
    assert _strip(run_pipeline(config("default"), device="cpu")[0]) == want
