"""The port's metrics tools and the four CLI subcommands that drive them
give what the JAX package's give on the same inputs: the running median
and its journal, the dataset statistics (serial and threaded), the sweep
corpora byte for byte, the execution-time sweeps' cases and reports, the
strategy diff, and ``swtorch info``, ``gen``, ``bench`` and ``diff``
against ``swtpu``'s."""

import filecmp
import json
import os
import re

import numpy as np
import pytest
import torch

from sparksmithwaterman_tpu import cli as jax_cli
from sparksmithwaterman_tpu.metrics import engineer_data as jax_engineer_data
from sparksmithwaterman_tpu.metrics import refset_info as jax_refset_info
from sparksmithwaterman_tpu.metrics.execution_times import run_sweeps as jax_run_sweeps
from sparksmithwaterman_tpu.metrics.running_median import RunningMedian as JaxRunningMedian
from sparksmithwaterman_tpu_torch import cli
from sparksmithwaterman_tpu_torch.config import AlignConfig
from sparksmithwaterman_tpu_torch.metrics import (
    RunningMedian,
    diff,
    engineer_data,
    format_info,
    get_info,
    get_info_threaded,
    print_all_info_threaded,
    run_sweeps,
)

torch.set_num_threads(1)


def _strip(path):
    return [l for l in open(path).read().splitlines() if "Execution Time" not in l]


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root) for d, _, fs in os.walk(root) for f in fs)


def _tiny_corpus(root):
    (root / "refs").mkdir(parents=True)
    (root / "inputs").mkdir()
    (root / "refs" / "ref1.rna.fna").write_text(">gi|1|alpha\nAACGTACGTTT\n>gi|2|beta\nGGGGGGGG\n")
    (root / "refs" / "ref2.rna.fna").write_text(">gi|3|gamma\nTTACGTACGTAA\n")
    (root / "inputs" / "input1.fa").write_text("ACGTACGT\nCGTA\n")
    (root / "inputs" / "input2.fa").write_text("GGGG\nTTAC\n")
    return str(root / "refs"), str(root / "inputs")


def test_running_median_matches_jax(tmp_path):
    stream = np.random.default_rng(3).integers(-50, 1000, size=301).tolist()
    ours, theirs = RunningMedian(str(tmp_path / "ours.txt")), JaxRunningMedian(str(tmp_path / "theirs.txt"))
    assert ours.median == 0.0
    for k, v in enumerate(stream, start=1):
        assert ours.add(v) == theirs.add(v) == float(np.median(stream[:k]))
    ours.close(), theirs.close()
    assert (tmp_path / "ours.txt").read_bytes() == (tmp_path / "theirs.txt").read_bytes()
    assert len((tmp_path / "ours.txt").read_text().splitlines()) == len(stream)


def test_format_info_matches_jax_and_threaded_equals_serial(tmp_path):
    ref_dir = tmp_path / "refs"
    jax_engineer_data.change_ref_num(str(ref_dir), scale=0.2)
    jax_engineer_data.change_ref_len(str(ref_dir / "lens"), scale=0.1)
    (ref_dir / "big").mkdir()
    (ref_dir / "big" / "many.rna.fna").write_text("".join(f">gi|{i}|x\nACGT\n" for i in range(1234)))
    (tmp_path / "empty").mkdir()
    for directory in (str(ref_dir), str(tmp_path / "empty")):
        serial = get_info(directory)
        text = format_info(serial)
        assert text == jax_refset_info.format_info(jax_refset_info.get_info(directory))
        for workers in (1, 5):
            assert get_info_threaded(directory, workers=workers) == serial
        out = tmp_path / "tinfo.txt"
        print_all_info_threaded(directory, str(out), workers=3)
        assert out.read_text() == text
    assert "|      1,234" in format_info(get_info(str(ref_dir)))
    empty = get_info_threaded(str(tmp_path / "empty"))
    assert (empty.num_files, empty.num_seqs, empty.median_bp, empty.mean_bp) == (0, 0, 0.0, 0.0)


@pytest.mark.parametrize("sweep", list(engineer_data.SWEEPS))
def test_generate_matches_jax_file_by_file(tmp_path, sweep):
    engineer_data.generate(str(tmp_path / "ours"), [sweep], scale=0.1)
    jax_engineer_data.generate(str(tmp_path / "theirs"), [sweep], scale=0.1)
    files = _files(tmp_path / "ours")
    assert files == _files(tmp_path / "theirs") and len(files) >= 4
    match, mismatch, errors = filecmp.cmpfiles(tmp_path / "ours", tmp_path / "theirs", files, shallow=False)
    assert match == files and not mismatch and not errors


def test_run_sweeps_matches_jax(tmp_path):
    data = tmp_path / "data"
    engineer_data.generate(str(data), scale=0.05)
    sweeps = ("read_len", "ref_len")
    ours = run_sweeps(str(data), str(tmp_path / "ours"), "batch", sweeps, device="cpu")
    theirs = jax_run_sweeps(str(data), str(tmp_path / "theirs"), "batch", sweeps)
    assert list(ours) == list(theirs) == list(sweeps)
    for sweep in sweeps:
        assert [r["case"] for r in ours[sweep]] == [r["case"] for r in theirs[sweep]]
        assert all(r["ms"] >= 0 for r in ours[sweep])
        assert json.load(open(tmp_path / "ours" / "batch" / f"{sweep}_summary.json")) == ours[sweep]
    reports = [f for f in _files(tmp_path / "theirs") if f.endswith(".txt")]
    assert reports == [f for f in _files(tmp_path / "ours") if f.endswith(".txt")] and len(reports) == 4
    for f in reports:
        assert _strip(tmp_path / "ours" / f) == _strip(tmp_path / "theirs" / f)


def test_diff_strategies_equal_diverged_and_count(tmp_path, monkeypatch):
    ref_dir, in_dir = _tiny_corpus(tmp_path)
    config = AlignConfig(ref_dir=ref_dir, in_dir=in_dir, out_dir=str(tmp_path), read_bucket=8, ref_bucket=8)
    equal, rows = diff.diff_strategies(config, "serial", "batch", str(tmp_path / "d1"), device="cpu")
    assert equal and [(r["file"], r["equal"], r["diff"]) for r in rows] == [
        ("result1.txt", True, ""), ("result2.txt", True, "")
    ]

    real = diff.run_pipeline

    def doctored(cfg, **kw):  # strategy b's second report names another read count
        paths = real(cfg, **kw)
        if cfg.strategy == "batch":
            text = open(paths[1]).read()
            open(paths[1], "w").write(text.replace("# Reads = 2", "# Reads = 3"))
        return paths

    monkeypatch.setattr(diff, "run_pipeline", doctored)
    equal, rows = diff.diff_strategies(config, "serial", "batch", str(tmp_path / "d2"), device="cpu")
    assert not equal and [r["equal"] for r in rows] == [True, False]
    assert rows[1]["diff"].startswith("--- serial/result2.txt\n+++ batch/result2.txt\n")
    assert "-# Reads = 2\n+# Reads = 3\n" in rows[1]["diff"]

    monkeypatch.setattr(diff, "run_pipeline", lambda cfg, **kw: real(cfg, **kw)[: 1 + (cfg.strategy == "batch")])
    with pytest.raises(RuntimeError, match="differ in count: 1 vs 2"):
        diff.diff_strategies(config, "serial", "batch", str(tmp_path / "d3"), device="cpu")


@pytest.mark.parametrize("command", ["info", "gen", "bench", "diff"])
def test_cli_matches_swtpu(tmp_path, capsys, monkeypatch, command):
    """Exit codes and printed lines of each subcommand as swtpu's; info and
    gen need no device and run on a host without CUDA, bench and diff take
    --device and refuse a missing CUDA device (exit 2, nothing written)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    data = tmp_path / "data"
    jax_engineer_data.generate(str(data), scale=0.05)
    ref_dir, in_dir = _tiny_corpus(tmp_path / "tiny")
    args = {
        "info": lambda out: ["info", "--ref-dir", str(data / "testRef"), "--out-file", str(out / "info.txt")],
        "gen": lambda out: ["gen", "--out-dir", str(out), "--sweeps", "read_len", "ref_num", "--scale", "0.1"],
        "bench": lambda out: ["bench", "--data-dir", str(data), "--out-dir", str(out), "--sweeps", "read_len"],
        "diff": lambda out: ["diff", "--ref-dir", ref_dir, "--in-dir", in_dir, "--out-dir", str(out), "--gap", "-5"],
    }[command]
    device = ["--device", "cpu"] if command in ("bench", "diff") else []

    def run(main, tag, extra=()):
        rc = main(args(tmp_path / tag) + list(extra))
        return rc, capsys.readouterr().out.replace(str(tmp_path / tag), "<out>")

    ours, theirs = run(cli.main, "ours", device), run(jax_cli.main, "theirs")
    if command == "bench":  # the cases and their order; the times differ
        assert ours[0] == theirs[0] == 0
        rows = json.loads(ours[1])
        assert [r["case"] for r in rows["read_len"]] == [r["case"] for r in json.loads(theirs[1])["read_len"]]
        assert all(r["ms"] >= 0 for r in rows["read_len"])
    else:
        assert ours == theirs and ours[0] == 0
    if command == "info":
        assert (tmp_path / "ours" / "info.txt").read_bytes() == (tmp_path / "theirs" / "info.txt").read_bytes()
        assert run(cli.main, "threads", ["--threads", "4"])[0] == 0
        assert (tmp_path / "threads" / "info.txt").read_bytes() == (tmp_path / "ours" / "info.txt").read_bytes()
    if command == "gen":
        assert _files(tmp_path / "ours") == _files(tmp_path / "theirs")
    if command == "diff":
        assert re.search(r"^identical: serial vs batch \(2 report\(s\), timing line ignored\)$", ours[1], re.M)
        real = diff.run_pipeline

        def doctored(cfg, **kw):  # strategy b's first report names another read count
            paths = real(cfg, **kw)
            if cfg.strategy == "batch":
                text = open(paths[0]).read()
                open(paths[0], "w").write(text.replace("# Reads = 2", "# Reads = 9"))
            return paths

        monkeypatch.setattr(diff, "run_pipeline", doctored)
        rc, out = run(cli.main, "diverged", device)
        assert rc == 1 and out.splitlines()[0] == "DIFF result1.txt" and "+# Reads = 9" in out
        assert out.splitlines()[-1] == "DIVERGED: serial vs batch (2 report(s), timing line ignored)"
    if device:
        rc = cli.main(args(tmp_path / "nocuda"))
        assert rc == 2 and "CUDA is not available" in capsys.readouterr().err
        assert not (tmp_path / "nocuda").exists()
