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
    # No card: the kernel readers and the program tracer's find nothing to
    # read and are left out, and the run is correct all the same.
    assert result["correct"], result["checks"]
    assert set(metrics) == {"parse_share", "dispatch_share", "traceback_share"}
    assert 0 < metrics["dispatch_share"]["value"] < 100
    assert all(v["unit"] == "%" for v in metrics.values())
    assert {name for name, _ in result["host_spans"]} >= {"file", "parse", "dispatch", "traceback", "report"}


def _readers(monkeypatch, **reads):
    """``spec.reader`` with the named readers' ``read`` replaced."""
    found = spec.reader

    def reader(name):
        module = found(name)
        if name in reads:
            module.read = reads[name]
        return module

    monkeypatch.setattr(spec, "reader", reader)


def _as_on_a_card(monkeypatch):
    """``run.unread`` judging a CPU run as it judges one on a card."""
    judge = run.unread
    monkeypatch.setattr(run, "unread", lambda units, values, absent, trace, card: judge(units, values, absent,
                                                                                       trace, True))


def test_a_traced_run_on_a_card_needs_every_per_layer_metric(tiny, monkeypatch):
    """Judged as on a card, a traced run whose readers read nothing is
    incorrect, though its outputs pass the check."""
    _as_on_a_card(monkeypatch)
    result = run.run_cell("tiny.x", 2**31 + 8, 8.0, True, "cpu", root=tiny, log=lambda m: None)
    assert result["checks"]["mismatches"]["value"] == 0
    assert not result["correct"]


def test_a_metric_absent_from_the_program_is_left_out(tiny, monkeypatch):
    """A reader that says the program has nothing of its kind, as on a
    parent older than its spans, leaves its metric out, and the run is
    correct, also when judged as on a card; one that reads nothing is
    left out too, and on a card makes the run incorrect."""
    _as_on_a_card(monkeypatch)
    cannot = ("k1_roofline", "k1_wide_roofline", "kernel_busy_share", "encode_share", "host_wait_share",
              "host_bound_idle_share")
    _readers(monkeypatch, parse_share=lambda trace: spec.ABSENT, **{n: lambda trace: spec.ABSENT for n in cannot})
    notes = []
    result = run.run_cell("tiny.x", 2**31 + 10, 8.0, True, "cpu", root=tiny, log=notes.append)
    assert result["correct"], result["checks"]
    assert set(result["metrics"]) == {"dispatch_share", "traceback_share"}
    assert any(n.startswith("metrics not read: none; absent from the program: encode_share") for n in notes)
    monkeypatch.undo()
    _as_on_a_card(monkeypatch)
    _readers(monkeypatch, parse_share=lambda trace: None, **{n: lambda trace: spec.ABSENT for n in cannot})
    result = run.run_cell("tiny.x", 2**31 + 11, 8.0, True, "cpu", root=tiny, log=notes.append)
    assert set(result["metrics"]) == {"dispatch_share", "traceback_share"}
    assert not result["correct"] and notes[-1].startswith("metrics not read: parse_share;")


def test_unread_names_what_a_correct_run_lacks():
    units = {"a": "%", "b": "%", "c": "%"}
    assert run.unread(units, {"a": 1.0}, {"b"}, True, True) == ["c"]
    assert run.unread(units, {"a": 1.0}, set(), True, False) == []
    assert run.unread(units, {"a": 1.0, "b": 2.0, "c": 3.0}, set(), True, True) == []
    assert run.unread({"real_gcups": "GCUPS", "setup_s": "s"}, {"setup_s": 1.0}, set(), False, False) == ["real_gcups"]


def test_an_untraced_run_without_an_end_to_end_metric_is_incorrect(tmp_path):
    """An end-to-end metric that the run cannot measure makes it
    incorrect, though its outputs pass the check."""
    from swbench.tests.conftest import tiny_root

    root = tiny_root(tmp_path)
    path = tmp_path / "BENCHMARK.json"
    bench = json.loads(path.read_text())
    bench["end_to_end"].append({"name": "file_s_p95", "unit": "s", "better": "lower", "bound": 0.1,
                                "source": "host_clock", "workloads": ["tiny.x"]})
    path.write_text(json.dumps(bench))
    result = run.run_cell("tiny.x", 2**31 + 9, 8.0, False, "cpu", root=root, log=lambda m: None)
    assert result["checks"]["mismatches"]["value"] == 0
    assert set(result["metrics"]) == {"real_gcups", "setup_s"}
    assert not result["correct"]


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
