"""The port stands alone: copied into a tree that holds only the port and
the C sources it builds (no JAX package), every module imports, every
re-exporting subpackage gives its ``__all__``, ``sites_for_pair_long``
runs, a tiny CPU pipeline runs (batch packed and unpacked, and shard_seq
and shard_refs on a mesh of two CPU entries), and so do ``swtorch
scaling``, ``gen``, ``info``, ``bench`` and ``diff``, the multi-chip dry
run, the step-chain roofline, both experiments and ``python -m
sparksmithwaterman_tpu_torch.bench --help``, with neither ``jax`` nor
``sparksmithwaterman_tpu`` loaded.  No source of the port imports them,
nor the JAX package's root ``bench.py`` or ``experiments/``."""

import os
import pathlib
import shutil
import subprocess
import sys
import textwrap

_REPO = pathlib.Path(__file__).resolve().parents[1]
_FORBIDDEN = ("jax", "jaxlib", "sparksmithwaterman_tpu")
# The JAX package's root bench.py and experiments/ (the port has its own).
_NOT_IMPORTED = _FORBIDDEN + ("bench", "experiments")

_SCRIPT = textwrap.dedent(
    """
    import pkgutil, sys
    import torch
    torch.set_num_threads(1)
    import sparksmithwaterman_tpu_torch as pkg
    for mod in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
        __import__(mod.name)
    import importlib
    for sub in ("core", "io", "models", "ops", "utils", "parallel", "metrics"):
        sub_pkg = importlib.import_module(pkg.__name__ + "." + sub)
        assert sub_pkg.__all__ and all(hasattr(sub_pkg, name) for name in sub_pkg.__all__), sub
    from sparksmithwaterman_tpu_torch.core import opt_alignments
    from sparksmithwaterman_tpu_torch.ops.longseq import sites_for_pair_long
    pair = ("TTACGTACGTAA", "CGTA")
    assert sites_for_pair_long(*pair, (5, -3, -4), device="cpu") == opt_alignments(*pair)[1]
    from sparksmithwaterman_tpu_torch import cli
    from sparksmithwaterman_tpu_torch.config import AlignConfig
    from sparksmithwaterman_tpu_torch.models.pipeline import run_pipeline
    from sparksmithwaterman_tpu_torch.parallel import SeqParallelBackend, ShardedBackend, build_mesh
    root = sys.argv[1]

    def report(strategy, backend=None, **kw):
        config = AlignConfig(ref_dir=root + "/refs", in_dir=root + "/inputs",
                             out_dir=root + "/out_" + strategy + str(sorted(kw.items())),
                             read_bucket=8, ref_bucket=8, strategy=strategy, **kw)
        if strategy == "shard_seq":
            backend = SeqParallelBackend(config, build_mesh(axis_names=("seq",), devices=["cpu", "cpu"]))
        elif strategy == "shard_refs":
            backend = ShardedBackend(config, build_mesh((2, 1), devices=["cpu", "cpu"]))
        path = run_pipeline(config, backend=backend, device="cpu")[0]
        return [l for l in open(path).read().splitlines() if "Execution Time" not in l]

    batch = report("batch")
    assert "Maximum alignment score = 60" in batch
    assert report("shard_seq") == batch and report("shard_refs") == batch
    assert report("batch", pack_reads=False) == batch
    assert cli.main(["scaling", "--device", "cpu", "--num-reads", "4", "--read-len", "16", "--num-refs", "4",
                     "--ref-len", "64"]) == 0
    sweeps = root + "/sweeps"
    assert cli.main(["gen", "--out-dir", sweeps, "--scale", "0.05"]) == 0
    assert cli.main(["info", "--ref-dir", sweeps + "/testRef", "--out-file", root + "/info.txt"]) == 0
    assert cli.main(["bench", "--data-dir", sweeps, "--out-dir", root + "/bench", "--device", "cpu"]) == 0
    assert cli.main(["diff", "--ref-dir", root + "/refs", "--in-dir", root + "/inputs", "--out-dir", root + "/diff",
                     "--device", "cpu"]) == 0
    from sparksmithwaterman_tpu_torch.dryrun import dryrun_multichip
    assert dryrun_multichip(4, device="cpu")["mesh"] == {"refs": 2, "reads": 2}
    from sparksmithwaterman_tpu_torch import bench
    from sparksmithwaterman_tpu_torch.experiments import packed_step_variants, triangle_timepack
    from sparksmithwaterman_tpu_torch.ops.microbench import step_roofline
    assert step_roofline(rb=8, m=32, steps=16, iters=1, unroll=8, device="cpu") > 0
    assert triangle_timepack.main(["--steps", "16", "--iters", "1", "--device", "cpu"]) == 0
    packed_step_variants.run("E", rows=8, m=32, c=1, n=8, iters=1, device="cpu")
    forbidden = %r
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in forbidden)
    assert not loaded, loaded
    print("standalone-ok")
    """
    % (_FORBIDDEN,)
)


def test_port_runs_without_loading_jax(tmp_path):
    tree = tmp_path / "tree"
    shutil.copytree(
        _REPO / "sparksmithwaterman_tpu_torch", tree / "sparksmithwaterman_tpu_torch",
        ignore=shutil.ignore_patterns("__pycache__"),
    )
    shutil.copytree(_REPO / "csrc", tree / "csrc", ignore=shutil.ignore_patterns("*.so"))
    data = tmp_path / "data"
    (data / "refs").mkdir(parents=True)
    (data / "inputs").mkdir()
    (data / "refs" / "ref1.rna.fna").write_text(">gi|1|alpha\nAACGTACGTTT\n>gi|2|beta\nGGGGGGGG\n")
    (data / "refs" / "ref2.rna.fna").write_text(">gi|3|gamma\nTTACGTACGTAA\n")
    (data / "inputs" / "input1.fa").write_text("ACGTACGT\nCGTA\n")
    env = dict(os.environ, PYTHONPATH=str(tree))
    proc = subprocess.run(
        [sys.executable, "-c", _SCRIPT, str(data)],
        capture_output=True, text=True, env=env, cwd=tree, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert "standalone-ok" in proc.stdout
    bench_help = subprocess.run(
        [sys.executable, "-m", "sparksmithwaterman_tpu_torch.bench", "--help"],
        capture_output=True, text=True, env=env, cwd=tree, timeout=120,
    )
    assert bench_help.returncode == 0, bench_help.stderr
    assert "--device" in bench_help.stdout


def test_sources_do_not_import_jax():
    for path in [*(_REPO / "sparksmithwaterman_tpu_torch").rglob("*.py"), _REPO / "chip_smoke.py"]:
        for line in path.read_text().splitlines():
            words = line.split()
            if len(words) >= 2 and words[0] in ("import", "from"):
                assert words[1].split(".")[0] not in _NOT_IMPORTED, f"{path}: {line}"
