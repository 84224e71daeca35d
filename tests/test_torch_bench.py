"""The port's headline bench at tiny sizes on the CPU: each leg's results
against the serial oracle, the JSON line's keys against the JAX bench's
(``BENCH_r05.json``), and no run without a card when one is asked for."""

import json
import pathlib

import numpy as np
import pytest
import torch

from sparksmithwaterman_tpu_torch import bench
from sparksmithwaterman_tpu_torch.core import oracle
from sparksmithwaterman_tpu_torch.io import get_reads, get_ref_seqs, iter_files

torch.set_num_threads(1)

_REPO = pathlib.Path(__file__).resolve().parents[1]


def _tiny(corpus_root):
    pipeline = dict(total_bp=2_500, n_reads=3, corpus_root=str(corpus_root))
    return {
        "kernel": dict(n_reads=4, read_len=16, n_refs=3, ref_len=64, iters=1),
        "e2e": dict(n_reads=6, n_refs=3, iters=1),
        "pipeline": pipeline,
        "corpus": pipeline,
        "readscale": pipeline,
        "longref": dict(n_reads=3, read_len=24, n_refs=2, ref_len=300, iters=1),
        "roofline": dict(rb=4, m=32, steps=32, iters=1, unroll=8),
    }


def test_kernel_leg_grid_equals_oracle():
    rate, spread, (reads, refs, grid) = bench.bench_kernel(
        n_reads=4, read_len=16, n_refs=3, ref_len=64, iters=1, repeats=3, device="cpu"
    )
    assert rate > 0 and len(spread) == 3 and spread == sorted(spread) and rate == spread[1]
    want = [[oracle.opt_alignments(f, r)[0] for f in refs] for r in reads]
    np.testing.assert_array_equal(grid, want)


def test_e2e_leg_totals_equal_oracle():
    rate, _, (reads, refs, totals) = bench.bench_e2e(n_reads=5, n_refs=3, iters=1, repeats=1, device="cpu")
    assert rate > 0
    want = [sum(oracle.opt_alignments(f, r)[0] for r in reads) for f in refs]
    np.testing.assert_array_equal(totals, want)


def test_pipeline_leg_report_equals_oracle_and_reuses_its_corpus(tmp_path):
    rate, spread, (meta, report) = bench.bench_pipeline(
        total_bp=2_500, n_reads=3, repeats=1, device="cpu", corpus_root=str(tmp_path)
    )
    assert rate > 0 and len(spread) == 1
    root = tmp_path / "p2500_3"
    reads = get_reads(root / "inputs" / "input1.fa", ">gi")
    refs = [rec for path in iter_files(str(root / "refs")) for rec in get_ref_seqs(path, ">gi")]
    assert sum(len(s) for _, s in refs) == meta["ref_bp"] and sum(map(len, reads)) == meta["read_bp"]
    best = max(sum(oracle.opt_alignments(seq, r)[0] for r in reads) for _, seq in refs)
    assert f"Maximum alignment score = {best}" in open(report).read()
    stamp = (root / ".done").stat().st_mtime_ns
    bench.bench_readscale(total_bp=2_500, n_reads=3, repeats=1, device="cpu", corpus_root=str(tmp_path))
    assert (root / ".done").stat().st_mtime_ns == stamp  # made once, then reused
    assert [p.name for p in tmp_path.iterdir()] == ["p2500_3"]  # no temporary left behind


def test_longref_leg_finds_the_planted_read():
    legs, (reads, refs, totals) = bench.bench_longref(
        n_reads=3, read_len=24, n_refs=2, ref_len=300, iters=2, repeats=1, device="cpu"
    )
    assert set(legs) == {"sustained", "single", "traceback_ms"}
    assert all(median > 0 and spread == [median] for median, spread in legs.values())
    assert reads[0] in refs[0]
    want = [sum(oracle.opt_alignments(f, r)[0] for r in reads) for f in refs]
    np.testing.assert_array_equal(totals, want)


def test_roofline_leg_and_smoke_on_cpu():
    rate, spread = bench.bench_roofline(rb=4, m=32, steps=32, iters=1, unroll=8, repeats=2, device="cpu")
    assert rate > 0 and len(spread) == 2
    assert bench.run_smoke("cpu") == "pass"


def test_line_has_the_jax_bench_keys(tmp_path):
    """BENCH_r05.json's keys, kernel_pct_vpu_sol renamed, card added and
    a spread for every leg; parity against the oracle passes."""
    jax_keys = set(json.loads((_REPO / "BENCH_r05.json").read_text())["parsed"])
    want = (jax_keys - {"kernel_pct_vpu_sol"}) | {"kernel_pct_roofline", "card"} | {
        f"{leg}_spread" for leg in ("pipeline", "corpus", "readscale", "longref", "longref_single",
                                    "longref_traceback", "roofline")
    }
    result, launches = bench.run_bench("cpu", repeats=1, sizes=_tiny(tmp_path))
    assert set(bench.KEYS) == want and tuple(result) == bench.KEYS
    assert result["thresholds"] == "none" and result["smoke"] == "pass" and result["card"] == "cpu"
    assert result["kernel_pct_roofline"] > 0 and result["threshold_detail"] is None
    assert set(launches) == {"kernel", "e2e", "pipeline", "corpus", "readscale", "longref", "roofline"}
    assert not any(any(leg.values()) for leg in launches.values())  # the CPU runs the plain versions
    json.dumps(result)


def test_main_without_a_card_exits_nonzero(capsys):
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    assert bench.main(["--device", "cuda"]) != 0
    assert "CUDA is not available" in capsys.readouterr().err
