"""Every public name of the JAX package has a counterpart in the port, under
the same module path and name (or one of the allow-listed exceptions
below), and the host helpers among them give what the JAX package's give
on the same inputs: the matrix printout, the direction characters, the
decoder and padder, the scheme's fields, the GCUPS counter, the profiler
trace, the pure-Python reference parser and the subpackages' exports."""

import ast
import dataclasses
import importlib
import json
import pathlib
import subprocess
import sys

import numpy as np
import pytest

from sparksmithwaterman_tpu.config import ScoringScheme as JaxScoringScheme
from sparksmithwaterman_tpu.core import oracle as jax_oracle
from sparksmithwaterman_tpu.io import fasta as jax_fasta
from sparksmithwaterman_tpu.io import report as jax_report
from sparksmithwaterman_tpu.ops import recurrence as jax_recurrence
from sparksmithwaterman_tpu.utils.profiling import GcupsCounter as JaxGcupsCounter
from sparksmithwaterman_tpu_torch import _native
from sparksmithwaterman_tpu_torch.cli import main as torch_cli
from sparksmithwaterman_tpu_torch.config import ScoringScheme
from sparksmithwaterman_tpu_torch.core import oracle
from sparksmithwaterman_tpu_torch.io import fasta, report
from sparksmithwaterman_tpu_torch.ops import recurrence
from sparksmithwaterman_tpu_torch.utils.profiling import GcupsCounter, profiler_trace

_REPO = pathlib.Path(__file__).resolve().parents[1]
_JAX, _PORT = "sparksmithwaterman_tpu", "sparksmithwaterman_tpu_torch"
_BASES = np.array(list("ACGTacgt"))

# Public names of the JAX package the port does not carry: TPU machinery.
# A key ending in ":" covers every name of that module.
_NOT_PORTED = {
    "cli:enable_compile_cache": "the JAX compile cache; the port builds its kernels once per source hash",
    "config:AlignConfig.use_pallas": "Pallas or lax; every path of the port runs its own hand kernel",
    "config:AlignConfig.read_block": "a TPU grid block of the row kernel; K5 plans its own launch",
    "ops.pallas_score:": "the VMEM planners and Pallas wrappers; their kernels are ops.cuda_score's",
}
# Public names the port has under another name: JAX name -> port name.
# A class's entry covers its methods and fields.
_RENAMED = {
    "models.batch_backend:BatchBackend": "models.batch_backend:TorchBatchBackend",
    "ops.microbench:vpu_step_roofline": "ops.microbench:step_roofline",
    "io._native_io:parse_ref_native": "_native:parse_ref",
    "ops._native:traceback_batch": "_native:traceback_batch",
    # The port's class inherits these methods from the batch backend.
    "parallel.seqparallel:SeqParallelBackend.best_of": "models.batch_backend:TorchBatchBackend.best_of",
    "parallel.seqparallel:SeqParallelBackend.sites_for_ref": "models.batch_backend:TorchBatchBackend.sites_for_ref",
    "parallel.seqparallel:SeqParallelBackend.totals": "models.batch_backend:TorchBatchBackend.totals",
}


def _public_names(package: str) -> set:
    """``module:name`` of every top-level function, class, method, class
    field and upper-case constant, and ``module:__all__:name`` of every
    ``__all__`` entry, of a package's sources."""
    root = _REPO / package
    names = set()
    for path in sorted(root.rglob("*.py")):
        mod = ".".join(path.relative_to(root).with_suffix("").parts).removesuffix("__init__").rstrip(".")
        for node in ast.parse(path.read_text()).body:
            if isinstance(node, (ast.FunctionDef, ast.ClassDef)) and not node.name.startswith("_"):
                names.add(f"{mod}:{node.name}")
                for item in node.body if isinstance(node, ast.ClassDef) else ():
                    if isinstance(item, ast.FunctionDef):
                        names.add(f"{mod}:{node.name}.{item.name}")
                    elif isinstance(item, ast.AnnAssign) and isinstance(item.target, ast.Name):
                        names.add(f"{mod}:{node.name}.{item.target.id}")
            elif isinstance(node, (ast.Assign, ast.AnnAssign)):
                for target in node.targets if isinstance(node, ast.Assign) else [node.target]:
                    if isinstance(target, ast.Name) and target.id == "__all__":
                        names.update(f"{mod}:__all__:{e.value}" for e in node.value.elts)
                    elif isinstance(target, ast.Name) and target.id.isupper():
                        names.add(f"{mod}:{target.id}")
    return {n for n in names if not n.split(":")[-1].split(".")[-1].startswith("_") or ":__all__:" in n}


def _port_name(jax_name: str):
    """The port's name for a JAX name; None where it is not ported."""
    if any(jax_name == key or (key.endswith(":") and jax_name.startswith(key)) for key in _NOT_PORTED):
        return None
    for old, new in _RENAMED.items():
        if jax_name == old or jax_name.startswith(old + "."):
            return new + jax_name[len(old):]
    return jax_name


def test_every_public_jax_name_has_a_counterpart():
    jax_names, port_names = _public_names(_JAX), _public_names(_PORT)
    missing = sorted(n for n in jax_names if _port_name(n) is not None and _port_name(n) not in port_names)
    assert not missing, missing
    for key in [*_NOT_PORTED, *_RENAMED]:  # no stale entry: each still names a JAX name the port lacks
        assert any(n == key or n.startswith(key if key.endswith(":") else key + ".") for n in jax_names), key
        assert key not in port_names, key


def test_subpackage_exports_match_jax():
    for sub in ("", ".core", ".io", ".models", ".ops", ".utils", ".parallel", ".metrics"):
        ours, theirs = importlib.import_module(_PORT + sub), importlib.import_module(_JAX + sub)
        assert set(theirs.__all__) <= set(ours.__all__), sub
        if sub in (".core", ".io", ".models", ".ops", ".utils"):
            assert ours.__all__ == theirs.__all__, sub
        exported = [getattr(ours, name) for name in ours.__all__]
        assert all(obj.__module__.startswith(_PORT) for obj in exported if callable(obj)), sub


def test_ops_import_builds_no_kernel_and_leaves_cuda_alone():
    code = (
        "import sys, torch\n"
        "import sparksmithwaterman_tpu_torch.ops as ops\n"
        "assert ops.__all__ and all(hasattr(ops, n) for n in ops.__all__)\n"
        "loaded = [m for m in ('sparksmithwaterman_tpu_torch.ops._cuda', 'sparksmithwaterman_tpu_torch.ops.cuda_score')"
        " if m in sys.modules]\n"
        "assert not loaded, loaded\n"
        "assert not torch.cuda.is_initialized()\n"
        "print('ops-ok')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=_REPO, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "ops-ok" in proc.stdout


_GOLDEN = (
    "\n"
    "   _  A  C  G  T  \n"
    "_  0  0  0  0  0  \n"
    "C  0  0  5  1  0  \n"
    "G  0  0  1  10 6  \n"
    "\n"
    "   _  A  C  G  T  \n"
    "_  -  -  -  -  -  \n"
    "C  -  -  a  d  -  \n"
    "G  -  -  i  a  d  \n"
)


@pytest.mark.parametrize("tie_semantics", ["serial", "distributed"])
def test_format_matrices_and_align_chars_match_jax(tie_semantics):
    rng = np.random.default_rng(61)
    schemes = [
        (ScoringScheme(tie_semantics=tie_semantics), JaxScoringScheme(tie_semantics=tie_semantics)),
        (ScoringScheme(types=("A", "I", "D", ".")), JaxScoringScheme(types=("A", "I", "D", "."))),
    ]
    for _ in range(3):
        ref = "".join(rng.choice(_BASES, size=int(rng.integers(6, 24))))
        read = "".join(rng.choice(_BASES, size=int(rng.integers(3, 12))))
        scores, dirs, _, _ = oracle.fill_matrices(ref, read, tie_semantics=tie_semantics)
        j_scores, j_dirs, _, _ = jax_oracle.fill_matrices(ref, read, tie_semantics=tie_semantics)
        np.testing.assert_array_equal(dirs, j_dirs)
        for ours, theirs in schemes:
            aligns = oracle.align_chars(dirs, ours)
            np.testing.assert_array_equal(aligns, jax_oracle.align_chars(j_dirs, theirs))
            got = report.format_matrices(scores, aligns, ref, read)
            assert got == jax_report.format_matrices(j_scores, jax_oracle.align_chars(j_dirs, theirs), ref, read)
    scores, dirs, _, _ = oracle.fill_matrices("ACGT", "CG", tie_semantics=tie_semantics)
    got = report.format_matrices(scores, oracle.align_chars(dirs), "ACGT", "CG")
    j_scores, j_dirs, _, _ = jax_oracle.fill_matrices("ACGT", "CG", tie_semantics=tie_semantics)
    assert got == jax_report.format_matrices(j_scores, jax_oracle.align_chars(j_dirs), "ACGT", "CG")
    if tie_semantics == "serial":
        assert got == _GOLDEN


def test_scheme_decode_and_padding_match_jax():
    rng = np.random.default_rng(62)
    seqs = ["".join(rng.choice(_BASES, size=int(n))) for n in (0, 5, 17, 3)] + ["ÄcGt"]
    for s in seqs:
        assert fasta.decode_seq(fasta.encode_seq(s)) == jax_fasta.decode_seq(jax_fasta.encode_seq(s))
    for pad in (fasta.READ_PAD, fasta.REF_PAD):
        np.testing.assert_array_equal(recurrence.encode_padded(seqs, 20, pad), jax_recurrence.encode_padded(seqs, 20, pad))
        np.testing.assert_array_equal(
            recurrence.encode_padded(iter(seqs[:4]), 17, pad), jax_recurrence.encode_padded(iter(seqs[:4]), 17, pad)
        )
    six = (2, -1, -2, ("x", "y", "z", "w"), "-", "distributed")
    for args in ((), (7, -2, -5), six):
        ours, theirs = ScoringScheme(*args), JaxScoringScheme(*args)
        assert [f.name for f in dataclasses.fields(ours)] == [f.name for f in dataclasses.fields(theirs)]
        assert dataclasses.astuple(ours) == dataclasses.astuple(theirs)
        assert ours.align_scores == theirs.align_scores and ours.types == theirs.types


def test_gcups_measure_matches_jax():
    ours, theirs = GcupsCounter(), JaxGcupsCounter()
    for cells in (1_000, 0, 123_456_789):
        for counter in (ours, theirs):
            with counter.measure(cells):
                sum(range(10_000))
    assert (ours.cells, ours.calls) == (theirs.cells, theirs.calls) == (123_457_789, 3)
    assert ours.seconds > 0 and ours.gcups > 0


def test_profiler_trace_and_cli_profile_dir(tmp_path):
    import torch

    with profiler_trace(None, device="cpu"):
        torch.ones(4).sum()
    with profiler_trace(""):
        pass
    assert not list(tmp_path.iterdir())
    with profiler_trace(str(tmp_path / "trace"), device="cpu"):
        torch.ones(4).sum()
    assert (tmp_path / "trace" / "trace.json").stat().st_size > 0
    json.loads((tmp_path / "trace" / "trace.json").read_text())
    (tmp_path / "refs").mkdir()
    (tmp_path / "inputs").mkdir()
    (tmp_path / "refs" / "r.fna").write_text(">gi|1|a\nAACGTACGTTT\n>gi|2|b\nGGGGGGGG\n")
    (tmp_path / "inputs" / "input1.fa").write_text("ACGTACGT\nCGTA\n")
    assert torch_cli([
        "align", "--ref-dir", str(tmp_path / "refs"), "--in-dir", str(tmp_path / "inputs"),
        "--out-dir", str(tmp_path / "out"), "--device", "cpu", "--profile-dir", str(tmp_path / "prof"),
    ]) == 0
    assert (tmp_path / "prof" / "trace.json").stat().st_size > 0


# The reference files of tests/test_io.py's parser checks: several records,
# an empty one, blank lines, \r\n endings, whitespace inside sequence lines.
_QUIRKS = (
    ">gi|1|first record  \nACGT\r\n  TTAA\n\n>gi|2|empty\n>gi|3|last\nacgtACGT\n",
    ">gi|2|x\nACGT\n  acg \n\n>gi|3|y\n>gi|4|z\nTT\n",
    ">gi|1|only\n",
)
_BAD = ("ACGT\n>gi|1|x\nACGT\n", "")


@pytest.mark.parametrize("native", [True, False], ids=["c_parser", "python_parser"])
def test_reference_parsers_match_jax(tmp_path, monkeypatch, native):
    assert fasta.USE_NATIVE_PARSER is True
    monkeypatch.setattr(fasta, "USE_NATIVE_PARSER", native)
    for k, content in enumerate(_QUIRKS):
        path = tmp_path / f"r{k}.fna"
        path.write_bytes(content.encode())
        want = jax_fasta._get_ref_seqs_py(path, ">gi")
        assert fasta.get_ref_seqs(path, ">gi") == want == _native.parse_ref(path, ">gi")
        assert fasta._get_ref_seqs_py(path, ">gi") == want
    for k, content in enumerate(_BAD):
        path = tmp_path / f"bad{k}.fna"
        path.write_text(content)
        with pytest.raises(ValueError) as theirs:
            jax_fasta._get_ref_seqs_py(path, ">gi")
        with pytest.raises(ValueError) as ours:
            fasta.get_ref_seqs(path, ">gi")
        if not native:
            assert str(ours.value) == str(theirs.value)
