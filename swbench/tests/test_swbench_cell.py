"""A cell added as files alone (a configuration, a traffic mix and their
entries in BENCHMARK.json) is found by name and runs on the CPU path."""

import json

import pytest

from swbench import run, spec


def test_a_cell_added_as_files_runs(tiny):
    bench = spec.load(tiny)
    entry = spec.cell(bench, "tiny.x")
    assert spec.traffic(entry, tiny)["reads_per_file"] == 6
    assert spec.config(bench, entry, tiny)["total_bp"] == 30000
    result = run.run_cell("tiny.x", 2**31 + 3, 8.0, False, "cpu", root=tiny, log=lambda m: None)
    assert result["correct"], result["checks"]
    assert set(result["metrics"]) == {"real_gcups", "setup_s"}
    assert result["metrics"]["real_gcups"]["unit"] == "GCUPS"
    assert json.loads(json.dumps(result)) == result


def test_a_traced_cpu_run_reads_its_host_spans(tiny):
    result = run.run_cell("tiny.x", 2**31 + 4, 8.0, True, "cpu", root=tiny, log=lambda m: None)
    metrics = result["metrics"]
    # No card: the kernel readers find nothing to read and are left out.
    assert set(metrics) == {"parse_share", "dispatch_share", "traceback_share"}
    assert 0 < metrics["dispatch_share"]["value"] < 100
    assert all(v["unit"] == "%" for v in metrics.values())
    assert {name for name, _ in result["host_spans"]} >= {"file", "parse", "dispatch", "traceback", "report"}


def test_a_four_card_cell_reports_the_twins(tmp_path, monkeypatch):
    """shard_refs over four CPU mesh entries, under ``real_gcups.4gpu``:
    each run reports the twins' names, read by the same readers."""
    from sparksmithwaterman_tpu_torch.parallel import engine

    from swbench.tests.conftest import tiny_root

    monkeypatch.setattr(engine, "mesh_devices", lambda device="cuda": ["cpu"] * 4)
    root = tiny_root(tmp_path, strategy="shard_refs", moves="real_gcups.4gpu")
    plain = run.run_cell("tiny.x", 2**31 + 6, 8.0, False, "cpu", root=root, log=lambda m: None)
    assert plain["correct"] and set(plain["metrics"]) == {"real_gcups.4gpu", "setup_s"}
    traced = run.run_cell("tiny.x", 2**31 + 6, 8.0, True, "cpu", root=root, log=lambda m: None)
    assert set(traced["metrics"]) == {"parse_share.4gpu", "dispatch_share.4gpu", "traceback_share.4gpu"}


def test_every_metric_has_a_reader_and_every_cell_its_files():
    bench = spec.load()
    for metric in bench["per_layer"]:
        mod = spec.reader(metric["name"])
        assert callable(mod.read)
    for entry in bench["workloads"]:
        assert spec.config(bench, entry)["align"]["strategy"]
        assert spec.traffic(entry)["reads_per_file"] > 0


def test_a_window_that_outlasts_its_pool_gives_no_result(tiny, monkeypatch):
    monkeypatch.setattr(run, "pool_size", lambda seconds, least_s: 1)
    with pytest.raises(run.PoolExhausted):
        run.run_cell("tiny.x", 2**31 + 5, 60.0, False, "cpu", root=tiny, log=lambda m: None)


def test_the_pool_outlasts_the_window():
    assert run.pool_size(30.0, 0.75) == 43
    assert run.pool_size(30.0, 0.0) > 1000


def test_the_pool_on_the_card_is_set_by_k1s_bound_alone():
    # short_reads: 512 reads, 58,880 bp, against 64,000,125 bp; an H100 SXM
    # does 132 x 128 x 1.98e9 / 1.5 = 22.30e12 cells a second at the bound.
    card = {"sms": 132, "max_sm_clock_mhz": 1980.0}
    cells = 58880 * 64000125
    least = run.least_file_s(cells, card, 1, warm_s=9.0)
    assert least == pytest.approx(cells / 22.3027e12, rel=1e-4)
    assert run.least_file_s(cells, card, 1, warm_s=0.5) == least
    assert run.pool_size(30.0, least) == 181
    assert run.least_file_s(cells, card, 4, warm_s=9.0) == pytest.approx(least / 4)
    assert run.least_file_s(cells, {}, 1, warm_s=3.0) == 1.5
