"""What a run may load and where it may run: nothing of JAX or the JAX
package (top-level names compared whole), a reference that imports
nothing of the system under test, and no result without a card or
without the port beside the benchmark."""

import ast
import os
import shutil
import subprocess
import sys

import pytest

from swbench.tests.conftest import REPO

FORBIDDEN = {"jax", "jaxlib", "flax", "sparksmithwaterman_tpu"}


def test_nothing_the_run_loads_is_jax():
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.path.insert(0, '.')\n"
        "import swbench.run, swbench.control, swbench.check, swbench.kernels, swbench.trace\n"
        "import swbench.layers\n"
        "for m in pkgutil.iter_modules(swbench.layers.__path__):\n"
        "    importlib.import_module('swbench.layers.' + m.name)\n"
        "import sparksmithwaterman_tpu_torch.models.aligner, sparksmithwaterman_tpu_torch.models.pipeline\n"
        "import sparksmithwaterman_tpu_torch.parallel.engine, sparksmithwaterman_tpu_torch.ops.cuda_score\n"
        "print(' '.join(sorted({n.split('.')[0] for n in sys.modules})))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, check=True,
                         env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    top = set(out.stdout.split())
    assert "sparksmithwaterman_tpu_torch" in top and "swbench" in top
    assert not top & FORBIDDEN


def test_forbidden_modules_compares_whole_names(monkeypatch):
    from swbench import run

    monkeypatch.setitem(sys.modules, "sparksmithwaterman_tpu_torchish", sys)
    assert run.forbidden_modules() == sorted(FORBIDDEN & {n.split(".")[0] for n in sys.modules})
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert "jax" in run.forbidden_modules()


def test_the_reference_imports_nothing_of_the_system():
    folder = os.path.join(REPO, "swbench", "reference")
    for name in os.listdir(folder):
        if name.endswith(".py"):
            tree = ast.parse(open(os.path.join(folder, name)).read())
            for node in ast.walk(tree):
                names = []
                if isinstance(node, ast.Import):
                    names = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom):
                    names = [node.module or ""]
                for full in names:
                    top = full.split(".")[0]
                    assert top not in FORBIDDEN | {"sparksmithwaterman_tpu_torch"}, (name, full)
                    assert top in {"__future__", "typing", "numpy", "torch"}, (name, full)


def _run(cwd):
    return subprocess.run([sys.executable, "swbench/run.py", "--workload", "refseq_rna.short_reads", "--seed",
                           "2147483999", "--seconds", "1", "--trace", "0"], cwd=cwd, capture_output=True, text=True,
                          env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})


def test_no_result_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = _run(REPO)
    assert out.returncode == 2 and out.stdout == ""
    assert "CUDA is not available" in out.stderr


def test_no_result_beside_nothing_but_the_benchmark(tmp_path):
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(REPO, "swbench"), tmp_path / "swbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0 and out.stdout == ""


@pytest.mark.gpu
def test_a_short_run_on_the_card_prints_its_result():
    import json

    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = _run(REPO)
    assert out.returncode == 0, out.stderr[-2000:]
    result = json.loads(out.stdout.splitlines()[-1])
    assert result["device"]["platform"] == "gpu" and list(result)[-1] == "checks"
