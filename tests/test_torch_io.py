"""The port's own copies of the JAX package's jax-free modules (parsing,
encoding, crawling, report, oracle, synthetic corpora) give what the JAX
package's modules give on the same inputs."""

import numpy as np
import pytest

from sparksmithwaterman_tpu.config import ScoringScheme as JaxScoringScheme
from sparksmithwaterman_tpu.core import oracle as jax_oracle
from sparksmithwaterman_tpu.io import crawler as jax_crawler
from sparksmithwaterman_tpu.io import fasta as jax_fasta
from sparksmithwaterman_tpu.io import report as jax_report
from sparksmithwaterman_tpu.metrics import engineer_data as jax_engineer_data
from sparksmithwaterman_tpu_torch.config import ScoringScheme
from sparksmithwaterman_tpu_torch.core import oracle
from sparksmithwaterman_tpu_torch.io import crawler, fasta, report
from sparksmithwaterman_tpu_torch.metrics import engineer_data

_BASES = np.array(list("ACGTacgt"))


def _seqs(rng, lens):
    return ["".join(rng.choice(_BASES, size=int(l))) for l in lens]


@pytest.mark.parametrize("tie_semantics", ["serial", "distributed"])
@pytest.mark.parametrize("scheme", [(5, -3, -4), (2, -1, -1)], ids=["default", "gap-1"])
def test_oracle_matches_jax_oracle(tie_semantics, scheme):
    rng = np.random.default_rng(31)
    ours = ScoringScheme(*scheme)
    theirs = JaxScoringScheme(*scheme)
    for read, ref in zip(_seqs(rng, rng.integers(0, 14, size=12)), _seqs(rng, rng.integers(0, 30, size=12))):
        assert oracle.opt_alignments(ref, read, ours, tie_semantics) == jax_oracle.opt_alignments(
            ref, read, theirs, tie_semantics
        )


def test_parsing_encoding_and_crawling_match_jax(tmp_path):
    rng = np.random.default_rng(7)
    (tmp_path / "a" / "b").mkdir(parents=True)
    (tmp_path / "a" / "b" / "r2.fna").write_text(">gi|2|x\nACGT\n  acg \n\n>gi|3|y\n>gi|4|z\nTT\n")
    (tmp_path / "a" / "r1.fna").write_text(">gi|1|w\n" + "\n".join(_seqs(rng, [60, 7, 0, 33])))
    (tmp_path / "reads.fa").write_text(">gi|reads\n ACGT \n\nacgtn\n")
    assert list(crawler.iter_files(tmp_path)) == list(jax_crawler.iter_files(tmp_path))
    for path in crawler.iter_files(tmp_path / "a"):
        assert fasta.get_ref_seqs(path, ">gi") == jax_fasta._get_ref_seqs_py(path, ">gi")
    assert fasta.get_reads(tmp_path / "reads.fa", ">gi") == jax_fasta.get_reads(tmp_path / "reads.fa", ">gi")
    with pytest.raises(ValueError):
        fasta.get_ref_seqs(tmp_path / "reads.fa", ">x")
    seqs = _seqs(rng, [0, 5, 17, 3]) + ["ÄcGt"]
    for pad in (fasta.READ_PAD, fasta.REF_PAD):
        np.testing.assert_array_equal(fasta.encode_batch(seqs, 20, pad), jax_fasta.encode_batch(seqs, 20, pad))
        np.testing.assert_array_equal(fasta.encode_batch(seqs[:4], 17, pad), jax_fasta.encode_batch(seqs[:4], 17, pad))
    for batch in (seqs, seqs[:4]):
        flat, lens = fasta.encode_concat(batch)
        np.testing.assert_array_equal(flat, np.concatenate([jax_fasta.encode_seq(s) for s in batch]))
        assert lens.tolist() == [len(s) for s in batch]


def test_report_matches_jax():
    opt = [
        (("gi|b", "ACGT"), [(1, ("ACG", "A_G")), (3, ("GT", "GT")), report.truncation_note(7)]),
        (("gi|a", ""), []),
    ]
    args = dict(reads=["ACGT", "", "GT"], num_refs=5, num_reads=3, max_score=12, exec_time_ms=9)
    assert report.truncation_note(7) == jax_report.truncation_note(7)
    assert report.build_report(opt=opt, **args) == jax_report.build_report(opt=opt, **args)


def test_synthetic_corpora_match_jax(tmp_path):
    got = engineer_data.refseq_like(str(tmp_path / "ours"), 30_000, file_bp=9_000, seed=5)
    want = jax_engineer_data.refseq_like(str(tmp_path / "theirs"), 30_000, file_bp=9_000, seed=5)
    assert got == want
    for name in sorted(p.name for p in (tmp_path / "theirs").iterdir()):
        assert (tmp_path / "ours" / name).read_bytes() == (tmp_path / "theirs" / name).read_bytes()
    assert engineer_data.reads_file(str(tmp_path / "o" / "in.fa"), 40, seed=3) == jax_engineer_data.reads_file(
        str(tmp_path / "t" / "in.fa"), 40, seed=3
    )
    assert (tmp_path / "o" / "in.fa").read_bytes() == (tmp_path / "t" / "in.fa").read_bytes()


def test_long_ref_corpus_matches_jax_experiment(tmp_path, monkeypatch):
    """The shard_seq corpus is the JAX package's
    experiments/shard_seq_pipeline.py generator, byte for byte."""
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parents[1] / "experiments" / "shard_seq_pipeline.py"
    spec = importlib.util.spec_from_file_location("shard_seq_pipeline", path)
    experiment = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(experiment)
    monkeypatch.setattr(experiment, "TOTAL_BP", 200_000)
    monkeypatch.setattr(experiment, "N_READS", 12)
    want = experiment.generate(str(tmp_path / "theirs"))
    got = engineer_data.long_ref_corpus(str(tmp_path / "ours"), total_bp=200_000, n_reads=12)
    assert got == {k: want[k] for k in ("ref_bp", "n_refs", "lens", "read_bp")}
    for rel in ("refs/refs1.rna.fna", "inputs/input1.fa"):
        assert (tmp_path / "ours" / rel).read_bytes() == (tmp_path / "theirs" / rel).read_bytes()
