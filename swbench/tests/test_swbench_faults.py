"""The correctness check on the CPU path: a sound run is correct; the
control and each planted fault that a cell can have make it incorrect, by
a compared number over its limit.

A step that returns its state unchanged is not among the faults: the
system keeps no state from one input file to the next."""

import pytest

from swbench import check, control, run
from swbench.tests.conftest import tiny_root

SECONDS = 8.0


def _run(root, patch=None, seed=2**31 + 7):
    return run.run_cell("tiny.x", seed, SECONDS, False, "cpu", root=root, patch=patch, log=lambda m: None)


def _over(result):
    """The compared numbers over their limits, and the parts that are not 0."""
    over = {name for name, c in result["checks"].items() if c["value"] > c["limit"]}
    return over | {name for name, v in result["check_parts"].items() if v and name != "files_checked"}


@pytest.fixture
def busy(tmp_path):
    """The tiny cell with 12 reads a file, so that some read ties."""
    return tiny_root(tmp_path, reads=12)


def test_a_sound_run_is_correct(busy):
    result = _run(busy)
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert result["correct"] and not _over(result)
    assert result["check_parts"]["files_checked"] >= 1
    assert list(result)[-1] == "checks"


@pytest.mark.parametrize("name, fails", [
    ("control", {"mismatches", "report_lines_differing"}),
    ("half_batch", {"mismatches", "winners_off", "winner_total_gap"}),
    ("altered_site", {"mismatches", "report_lines_differing"}),
    ("altered_score", {"mismatches", "winners_off", "winner_total_gap"}),
    ("dropped_report", {"mismatches", "reports_missing"}),
])
def test_the_control_and_each_fault_fail(busy, name, fails):
    result = _run(busy, control.PATCHES[name]())
    assert result["attempted"] >= 1
    assert not result["correct"]
    assert fails <= _over(result)


def test_no_exchange_between_cards_fails(tmp_path, monkeypatch):
    """shard_refs on a mesh of four CPU entries: with only the first
    entry's sums the winner set changes (at this seed the true winner lies
    on another entry), and the check sees a rival at or above the reported
    best."""
    from sparksmithwaterman_tpu_torch.parallel import engine

    monkeypatch.setattr(engine, "mesh_devices", lambda device="cuda": ["cpu"] * 4)
    monkeypatch.setattr(check, "LONGEST_REFS", 40)  # every reference a rival
    root = tiny_root(tmp_path, strategy="shard_refs")
    sound = _run(root, seed=8)
    assert sound["correct"]
    result = _run(root, control.PATCHES["no_exchange"](), seed=8)
    assert result["attempted"] >= 1 and not result["correct"]
    assert {"mismatches", "sampled_refs_at_or_above_best"} <= _over(result)
