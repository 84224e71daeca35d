"""Fixtures of the benchmark's CPU tests: a checkout root in a temporary
directory whose BENCHMARK.json adds tiny cells as files alone."""

import json
import os
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if REPO not in sys.path:
    sys.path.insert(0, REPO)


def tiny_root(path, strategy="batch", reads=6, moves="real_gcups"):
    """A root holding BENCHMARK.json with the repository's cells and a tiny
    cell ``tiny.x`` (config ``tiny``, traffic ``tiny``), added as files,
    under the end-to-end metric ``moves`` and the per-layer ones that move
    it."""
    os.makedirs(path / "swbench" / "configs")
    os.makedirs(path / "swbench" / "traffic")
    with open(os.path.join(REPO, "swbench", "configs", "refseq_rna.json")) as f:
        cfg = json.load(f)
    cfg.update(total_bp=30000, file_bp=12000, max_bp=3000, min_bp=80)
    cfg["align"].update(strategy=strategy, ref_batch_bp=10000)
    (path / "swbench" / "configs" / "tiny.json").write_text(json.dumps(cfg))
    with open(os.path.join(REPO, "swbench", "traffic", "short_reads.json")) as f:
        mix = json.load(f)
    mix.update(reads_per_file=reads, read_min_bp=30, read_max_bp=40)
    (path / "swbench" / "traffic" / "tiny.json").write_text(json.dumps(mix))
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["configs"].append({"name": "tiny", "source": "https://example.org/tiny", "file": "swbench/configs/tiny.json",
                             "reduced": [], "why": "a CPU test"})
    bench["workloads"].append({"name": "tiny.x", "config": "tiny", "traffic": "tiny", "chips": 1, "why": "a CPU test"})
    for metric in bench["end_to_end"] + bench["per_layer"]:
        if moves in (metric["name"], metric.get("moves")):
            metric["workloads"].append("tiny.x")
    (path / "BENCHMARK.json").write_text(json.dumps(bench))
    return str(path)


@pytest.fixture
def tiny(tmp_path):
    return tiny_root(tmp_path)


@pytest.fixture(autouse=True)
def program_tracer_off():
    """The port's tracer off and empty after each test: a traced run's
    readers switch it on when they are imported."""
    yield
    from sparksmithwaterman_tpu_torch.utils import profiling

    profiling.disable()
    profiling.reset()
