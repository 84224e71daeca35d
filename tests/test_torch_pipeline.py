"""The PyTorch port's slice as a whole: ``run_pipeline`` on the CPU gives
report bytes identical (apart from the Execution Time line) to the JAX
package's batch and serial strategies, through both traceback branches,
and resumes through its journal."""

import dataclasses

import numpy as np
import pytest
import torch

from sparksmithwaterman_tpu.config import AlignConfig as JaxAlignConfig
from sparksmithwaterman_tpu.models.aligner import SerialBackend
from sparksmithwaterman_tpu.models.pipeline import run_pipeline as jax_run_pipeline
from sparksmithwaterman_tpu_torch.cli import main as torch_cli
from sparksmithwaterman_tpu_torch.config import AlignConfig
from sparksmithwaterman_tpu_torch.models import batch_backend
from sparksmithwaterman_tpu_torch.models.pipeline import run_pipeline

torch.set_num_threads(1)

_BASES = np.array(list("ACGT"))


def _strip(path):
    return [l for l in open(path).read().splitlines() if "Execution Time" not in l]


def _corpus(root, rng):
    """Random tiny corpus with adversarial shapes: empty reads, length-1
    refs, a duplicated ref (tie set), two ref files."""
    (root / "refs").mkdir(parents=True)
    (root / "inputs").mkdir()
    n_refs = int(rng.integers(3, 7))
    seqs = ["".join(rng.choice(_BASES, size=int(rng.integers(1, 120)))) for _ in range(n_refs)]
    seqs[1] = seqs[0]
    seqs[2] = seqs[2][:1]
    half = n_refs // 2
    for fi, chunk in enumerate((seqs[:half], seqs[half:])):
        lines = []
        for j, s in enumerate(chunk):
            lines += [f">gi|{fi}{j}|fuzz{fi}{j}", s]
        (root / "refs" / f"r{fi}.rna.fna").write_text("\n".join(lines) + "\n")
    reads = [
        "".join(rng.choice(_BASES, size=int(l)))
        for l in rng.integers(1, 40, size=int(rng.integers(1, 9)))
    ]
    reads.append("")
    (root / "inputs" / "input1.fa").write_text("\n".join(reads) + "\n")


def _config(root, tag, cls=AlignConfig):
    return cls(
        ref_dir=str(root / "refs"),
        in_dir=str(root / "inputs"),
        out_dir=str(root / f"out_{tag}"),
        read_bucket=8,
        ref_bucket=8,
    )


@pytest.mark.parametrize("windowed", [False, True], ids=["full_fill", "windowed"])
def test_reports_match_jax_batch_and_serial(tmp_path, monkeypatch, windowed):
    if windowed:  # every winner through the argmax pass + window walks
        monkeypatch.setattr(batch_backend, "_WINDOW_READS", 1)
    rng = np.random.default_rng(57)
    for trial in range(3):
        root = tmp_path / f"fuzz{trial}"
        _corpus(root, rng)
        cfg = _config(root, "torch")
        got = _strip(run_pipeline(cfg, device="cpu")[0])
        for strategy in ("batch", "serial"):
            ref = dataclasses.replace(_config(root, strategy, JaxAlignConfig), strategy=strategy)
            assert got == _strip(jax_run_pipeline(ref)[0]), f"trial {trial} vs {strategy}"


def test_resume_skips_completed_inputs(tmp_path, monkeypatch):
    _corpus(tmp_path, np.random.default_rng(3))
    (tmp_path / "inputs" / "input2.fa").write_text("ACGTACGT\nCGTA\n")
    cfg = _config(tmp_path, "resume")
    first = run_pipeline(cfg, device="cpu")
    assert len(first) == 2
    calls = []
    original = batch_backend.TorchBatchBackend.best_of_async
    monkeypatch.setattr(
        batch_backend.TorchBatchBackend,
        "best_of_async",
        lambda self, *a: calls.append(1) or original(self, *a),
    )
    assert run_pipeline(cfg, resume=True, device="cpu") == first
    assert calls == []
    # A changed input is re-run; the other is still skipped.
    (tmp_path / "inputs" / "input2.fa").write_text("ACGTAAGT\n")
    assert run_pipeline(cfg, resume=True, device="cpu") == first
    assert len(calls) == 1


def test_totals_and_best_of_match_serial_backend():
    rng = np.random.default_rng(13)
    reads = ["".join(rng.choice(_BASES, size=int(l))) for l in rng.integers(0, 60, size=12)]
    refs = ["".join(rng.choice(_BASES, size=int(l))) for l in rng.integers(0, 200, size=9)]
    refs[4] = refs[2]
    config = AlignConfig(ref_dir=".", in_dir=".", out_dir=".")
    backend = batch_backend.TorchBatchBackend(config, "cpu")
    want = SerialBackend().totals(reads, refs)
    np.testing.assert_array_equal(backend.totals(reads, refs), want)
    assert backend.best_of(reads, refs) == SerialBackend().best_of(reads, refs)
    assert backend.best_of([], refs) == (0, list(range(len(refs))))


def test_trace_capacity_overflow_falls_back_to_host_walk(monkeypatch):
    monkeypatch.setattr(batch_backend, "_TRACE_CAPACITY", 2)
    reads = ["ACGT", "AC"]
    ref = "ACGTTTACGTTTACGT"
    config = AlignConfig(ref_dir=".", in_dir=".", out_dir=".", read_bucket=8, ref_bucket=8)
    got = batch_backend.TorchBatchBackend(config, "cpu").sites_for_ref(ref, reads)
    assert got == SerialBackend().sites_for_ref(ref, reads)
    assert sum(1 for s in got if s[1] == ("ACGT", "ACGT")) == 3


def test_cli_align_on_cpu_and_no_cuda_fallback(tmp_path, capsys):
    _corpus(tmp_path, np.random.default_rng(5))
    args = ["align", "--ref-dir", str(tmp_path / "refs"), "--in-dir", str(tmp_path / "inputs")]
    assert torch_cli(
        args + ["--out-dir", str(tmp_path / "o_cpu"), "--device", "cpu", "--profile-dir", str(tmp_path / "prof")]
    ) == 0
    assert capsys.readouterr().out.strip().endswith("result1.txt")
    assert (tmp_path / "prof" / "trace.json").stat().st_size > 0
    if not torch.cuda.is_available():
        assert torch_cli(args + ["--out-dir", str(tmp_path / "o_gpu")]) != 0
        assert not (tmp_path / "o_gpu").exists()
    for strategy in ("shard_seq", "shard_refs", "shard_reads"):
        out = tmp_path / f"o_{strategy}"
        assert torch_cli(args + ["--out-dir", str(out), "--strategy", strategy, "--device", "cpu"]) == 0
        assert _strip(out / "result1.txt") == _strip(tmp_path / "o_cpu" / "result1.txt")
