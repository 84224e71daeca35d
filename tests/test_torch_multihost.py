"""Multi-host runs of the port (``parallel.multihost``) and its multi-chip
dry run (``dryrun``): the manifest shards, a single process equal to
``run_pipeline`` and to the JAX package's multi-host run (report and
journal), the merge across hosts, the per-shard journal, the process
group's init method, a real two-process run over gloo with a ``file://``
init method, and the dry run on meshes of CPU entries."""

import json
import os
import pathlib
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest
import torch

from sparksmithwaterman_tpu.config import AlignConfig as JaxAlignConfig
from sparksmithwaterman_tpu.parallel import multihost as jax_multihost
from sparksmithwaterman_tpu_torch import dryrun
from sparksmithwaterman_tpu_torch.config import AlignConfig
from sparksmithwaterman_tpu_torch.models.aligner import get_backend
from sparksmithwaterman_tpu_torch.models.pipeline import run_pipeline
from sparksmithwaterman_tpu_torch.parallel import multihost
from sparksmithwaterman_tpu_torch.parallel.multihost import HostConfig, run_multihost_pipeline, shard_manifest

torch.set_num_threads(1)

_REPO = pathlib.Path(__file__).resolve().parents[1]


def _strip(path):
    return [l for l in open(path).read().splitlines() if "Execution Time" not in l]


def _corpus(root):
    """Three reference files (round-robin over two hosts: files 0 and 2,
    then file 1); input 1's best total is reached in both shards, input
    2's in host 1's only."""
    (root / "refs").mkdir(parents=True)
    (root / "inputs").mkdir()
    (root / "refs" / "r1.fna").write_text(">gi|1|aa\nAACGTACGTTT\n")
    (root / "refs" / "r2.fna").write_text(">gi|2|bb\nTTTTACGTACGTAAAA\n>gi|3|cc\nGGGG\n")
    (root / "refs" / "r3.fna").write_text(">gi|4|dd\nCCCCCC\n")
    (root / "inputs" / "i1.fa").write_text("ACGTACGT\nCGTA\n")
    (root / "inputs" / "i2.fa").write_text("TTTTACG\nGGGG\n")
    return dict(ref_dir=str(root / "refs"), in_dir=str(root / "inputs"), read_bucket=8, ref_bucket=8)


def test_shard_manifest_partition():
    files = [f"f{i}" for i in range(10)]
    shards = [shard_manifest(files, 3, h) for h in range(3)]
    assert sorted(idx for shard in shards for idx, _ in shard) == list(range(10))
    assert shards[0] == [(0, "f0"), (3, "f3"), (6, "f6"), (9, "f9")]
    assert shards == [jax_multihost.shard_manifest(files, 3, h) for h in range(3)]


@pytest.mark.parametrize("strategy", ["serial", "batch"])
def test_single_process_matches_pipeline_and_jax(tmp_path, strategy):
    base = dict(_corpus(tmp_path), strategy=strategy)
    ours = run_multihost_pipeline(AlignConfig(out_dir=str(tmp_path / "mh"), **base), device="cpu")
    single = run_pipeline(AlignConfig(out_dir=str(tmp_path / "sp"), **base), device="cpu")
    theirs = jax_multihost.run_multihost_pipeline(JaxAlignConfig(out_dir=str(tmp_path / "jax"), **base))
    assert [os.path.basename(p) for p in ours] == ["result1.txt", "result2.txt"]
    for a, b, c in zip(ours, single, theirs):
        assert _strip(a) == _strip(b) == _strip(c)
    for k in (1, 2):  # the same journal, key included (same files, same mtimes)
        name = f".partial/input{k}.host0.journal.json"
        assert json.load(open(tmp_path / "mh" / name)) == json.load(open(tmp_path / "jax" / name))


def test_simulated_two_host_merge(tmp_path, monkeypatch):
    """Two hosts on one filesystem, the collectives stubbed: host 1 runs
    first and writes its candidates, host 0 replays host 1's values and
    writes the reports, whose winners come from both shards."""
    config = AlignConfig(out_dir=str(tmp_path / "out"), strategy="batch", **_corpus(tmp_path))
    gathered = {}

    def fake_allgather(local, host):
        gathered.setdefault(host.process_id, []).append(local)
        theirs = gathered.get(1 - host.process_id)
        other = theirs[len(gathered[host.process_id]) - 1] if theirs else 0
        return np.asarray([local, other], np.int64)

    monkeypatch.setattr(multihost, "_allgather_best", fake_allgather)
    monkeypatch.setattr(multihost, "_barrier", lambda host, name: None)
    run_multihost_pipeline(config, HostConfig(num_processes=2, process_id=1), device="cpu")
    paths = run_multihost_pipeline(config, HostConfig(num_processes=2, process_id=0), device="cpu")
    want = run_pipeline(AlignConfig(out_dir=str(tmp_path / "sp"), strategy="serial", **_corpus(tmp_path / "c2")),
                        device="cpu")
    for got, ref in zip(paths, want):
        assert _strip(got) == _strip(ref)
    assert ">gi|2|bb" in open(paths[0]).read() and "Maximum alignment score = 60" in open(paths[0]).read()
    assert gathered[0][1::2] == gathered[1][1::2] == [2, 2]  # each shard holds two references


class _Spy:
    """A backend that counts best_of calls, refuses totals, and can refuse to score at all."""

    def __init__(self, inner, score=True):
        self.inner, self.score, self.best_of_calls = inner, score, 0

    def totals(self, reads, refs):
        raise AssertionError("a multi-host flush must take the backend's best_of")

    def best_of(self, reads, refs):
        if not self.score:
            raise AssertionError("the journal should have prevented rescoring")
        self.best_of_calls += 1
        return self.inner.best_of(reads, refs)

    def sites_for_ref(self, ref, reads):
        return self.inner.sites_for_ref(ref, reads)


def test_per_shard_journal_resume_and_invalidation(tmp_path):
    config = AlignConfig(out_dir=str(tmp_path / "out"), strategy="batch", **_corpus(tmp_path))
    spy = _Spy(get_backend(config, "cpu"))
    first = run_multihost_pipeline(config, backend=spy)
    want = [_strip(p) for p in first]
    assert spy.best_of_calls == 2  # one flush per input
    again = run_multihost_pipeline(config, backend=_Spy(spy.inner, score=False), resume=True)
    assert [_strip(p) for p in again] == want
    # A torn journal is scored again, not trusted.
    (tmp_path / "out" / ".partial" / "input2.host0.journal.json").write_text('{"key": ')
    with pytest.raises(AssertionError, match="prevented rescoring"):
        run_multihost_pipeline(config, backend=_Spy(spy.inner, score=False), resume=True)
    run_multihost_pipeline(config, backend=spy, resume=True)
    # A reference file written anew (a later mtime) invalidates the shard key.
    time.sleep(0.01)
    (tmp_path / "refs" / "r3.fna").write_text(">gi|4|dd\nCCCCCCA\n")
    with pytest.raises(AssertionError, match="prevented rescoring"):
        run_multihost_pipeline(config, backend=_Spy(spy.inner, score=False), resume=True)


def test_initialize_picks_the_init_method(monkeypatch):
    import torch.distributed as dist

    calls = []
    monkeypatch.setattr(dist, "init_process_group", lambda backend, **kw: calls.append((backend, kw)))
    HostConfig(coordinator_address="h:1", init_method="file:///x").initialize()  # one process: nothing
    HostConfig(num_processes=2, process_id=1, coordinator_address="10.0.0.1:8476").initialize()
    HostConfig(num_processes=2, coordinator_address="h:1", init_method="file:///shared/rdv").initialize()
    HostConfig(num_processes=3, process_id=2).initialize()
    assert calls == [
        ("gloo", dict(init_method="tcp://10.0.0.1:8476", world_size=2, rank=1)),
        ("gloo", dict(init_method="file:///shared/rdv", world_size=2, rank=0)),
        ("gloo", dict(init_method="env://", world_size=3, rank=2)),
    ]


_DRIVER = textwrap.dedent(
    """
    import sys
    import torch
    import torch.distributed as dist
    from sparksmithwaterman_tpu_torch.config import AlignConfig
    from sparksmithwaterman_tpu_torch.parallel import ShardedBackend, build_mesh
    from sparksmithwaterman_tpu_torch.parallel.multihost import HostConfig, run_multihost_pipeline
    torch.set_num_threads(1)
    pid, strategy, root, rdv = int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4]
    host = HostConfig(num_processes=2, process_id=pid, init_method="file://" + rdv)
    host.initialize()
    cfg = AlignConfig(ref_dir=root + "/refs", in_dir=root + "/inputs", out_dir=root + "/out2p",
                      strategy=strategy, read_bucket=8, ref_bucket=8)
    # shard_refs: every process drives a mesh of two entries.
    backend = ShardedBackend(cfg, build_mesh((2, 1), devices=["cpu", "cpu"])) if strategy == "shard_refs" else None
    print(run_multihost_pipeline(cfg, host, backend=backend, device="cpu"))
    dist.destroy_process_group()
    """
)


@pytest.mark.parametrize("strategy", ["serial", "shard_refs"])
def test_real_two_process_gloo(tmp_path, strategy):
    """Two processes, a real gloo group over a file:// rendezvous (no
    network): all_gather, barrier and the shared-filesystem merge."""
    _corpus(tmp_path)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(p for p in (str(_REPO), os.environ.get("PYTHONPATH")) if p))
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", _DRIVER, str(pid), strategy, str(tmp_path), str(tmp_path / "rdv")],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        for pid in (0, 1)
    ]
    try:
        for p in procs:
            out, err = p.communicate(timeout=120)
            assert p.returncode == 0, err[-2000:]
            assert "result2.txt" in out
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    want = run_pipeline(AlignConfig(out_dir=str(tmp_path / "out1p"), strategy="serial", **_corpus(tmp_path / "c")),
                        device="cpu")
    for k, ref in enumerate(want, start=1):
        assert _strip(tmp_path / "out2p" / f"result{k}.txt") == _strip(ref)
        for pid in (0, 1):
            cands = json.load(open(tmp_path / "out2p" / ".partial" / f"input{k}.host{pid}.json"))
            assert all(len(c) == 2 and all(isinstance(x, int) for x in c) for c in cands)
    # Input 1's winners: gi|1 in host 0's shard (file 0), gi|2 in host 1's (file 1).
    assert [json.load(open(tmp_path / "out2p" / ".partial" / f"input1.host{pid}.json")) for pid in (0, 1)] == [
        [[0, 0]], [[1, 0]]
    ]


@pytest.mark.parametrize("n_devices,shape", [(4, {"refs": 2, "reads": 2}), (6, {"refs": 3, "reads": 2})])
def test_dryrun_multichip_on_cpu_entries(n_devices, shape):
    got = dryrun.dryrun_multichip(n_devices, device="cpu")
    assert got["mesh"] == shape and got["devices"] == ["cpu"] * n_devices
    assert got["reads"] == (8 * shape["reads"], 16) and got["refs"] == (2 * shape["refs"], 32)


def test_dryrun_raises_on_a_mismatch(monkeypatch):
    real = dryrun.sharded_totals
    monkeypatch.setattr(dryrun, "sharded_totals", lambda *a, **k: real(*a, **k) + 1)
    with pytest.raises(RuntimeError, match="column sums differ"):
        dryrun.dryrun_multichip(4, device="cpu")
    if not torch.cuda.is_available():  # no quiet switch to the CPU
        with pytest.raises(RuntimeError, match="no CUDA device"):
            dryrun.dryrun_multichip(4)
