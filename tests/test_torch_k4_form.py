"""K4's two forms: the rule that picks the 16-bit form for unpacked reads,
the plain version at the scores where the rule changes its answer, and
the unpacked dispatch that sizes each read group's lanes to its longest
read.

``cuda_score.score_grid_diag`` takes the s16x2 form (two reads per warp in
the 16-bit halves of each register) exactly when ``cuda_score.k1_form``
says every score and intermediate fits int16, with m the width of the
reads tensor; the kernels run only on the card (``chip_smoke.py`` [0],
[8]).  Here the plain version, which both forms compute, is held to the
JAX function the 16-bit form stands for (``pallas_score_grid_diag`` with
``state_dtype='int16'``, interpret mode), to the oracle and to the JAX row
recurrence, and the backend's unpacked path to the JAX ``BatchBackend``.
Tolerance 0 throughout: scores are integers.
"""

import inspect

import numpy as np
import pytest
import torch

from sparksmithwaterman_tpu.config import AlignConfig as JaxAlignConfig
from sparksmithwaterman_tpu.models.batch_backend import BatchBackend
from sparksmithwaterman_tpu.models.pipeline import run_pipeline as jax_run_pipeline
from sparksmithwaterman_tpu.ops.pallas_score import pallas_score_grid_diag
from sparksmithwaterman_tpu.ops.recurrence import score_grid as jax_score_grid
from sparksmithwaterman_tpu_torch.config import AlignConfig, ScoringScheme
from sparksmithwaterman_tpu_torch.core import oracle
from sparksmithwaterman_tpu_torch.io.fasta import READ_PAD, REF_PAD, encode_batch
from sparksmithwaterman_tpu_torch.models import batch_backend
from sparksmithwaterman_tpu_torch.models.batch_backend import TorchBatchBackend
from sparksmithwaterman_tpu_torch.models.pipeline import run_pipeline
from sparksmithwaterman_tpu_torch.ops import cuda_score

torch.set_num_threads(1)

PARAMS = (5, -3, -4)
_BASES = np.array(list("ACGT"))


def _seqs(rng, lens):
    return ["".join(rng.choice(_BASES, size=int(n))) for n in lens]


def _grid(reads, refs, m=None):
    m = max(map(len, reads)) if m is None else m
    n = max(1, max(map(len, refs)))
    return torch.from_numpy(encode_batch(reads, m, READ_PAD)), torch.from_numpy(encode_batch(refs, n, REF_PAD))


@pytest.mark.parametrize(
    "m, params, form",
    [
        (1024, (31, -3, -4), "s16x2"),  # 31 x 1,024 = 31,744 fits
        (1024, (32, -3, -4), "int32"),  # 32 x 1,024 = 32,768 does not
        (1025, (5, -3, -4), "int32"),  # reads wider than one pass run in stripes
        (150, (5, -3, -32768), "s16x2"),
        (150, (5, -3, -32769), "int32"),
    ],
)
def test_k4_form_at_the_edges_of_its_rule(m, params, form):
    """The rule at K4's unpacked widths, and the private entry of the A/B
    refusing the s16x2 form exactly where K4's rule (k1k4_form: k1_form's,
    widened to striped reads) says int32."""
    assert cuda_score.k1_form(m, *params) == form
    k4_form = cuda_score.k1k4_form(m, *params)
    assert k4_form == (form if m <= cuda_score.ONE_PASS_LANES else "s16x2")
    reads_t, refs_t = _grid(["ACGT"], ["ACGTT"], m)
    want = cuda_score.score_grid_diag_plain(reads_t, refs_t, *params)
    np.testing.assert_array_equal(cuda_score._score_grid_diag(reads_t, refs_t, *params, form="int32"), want)
    if k4_form == "s16x2":
        np.testing.assert_array_equal(cuda_score._score_grid_diag(reads_t, refs_t, *params, form="s16x2"), want)
    else:
        with pytest.raises(ValueError):
            cuda_score._score_grid_diag(reads_t, refs_t, *params, form="s16x2")


def test_plain_matches_jax_int16_state():
    """K4's plain version against the JAX function with 16-bit state in
    interpret mode: an odd read count (an empty read and a 1 bp read
    among them) against refs of 1 bp and more, every pair."""
    rng = np.random.default_rng(11)
    reads = _seqs(rng, rng.integers(2, 40, 5)) + ["", "G"]
    refs = _seqs(rng, [1, 37, 60, 12])
    reads_t, refs_t = _grid(reads, refs, 40)
    assert reads_t.shape[0] % 2 == 1
    want = pallas_score_grid_diag(
        reads_t.numpy(), refs_t.numpy(), *PARAMS, read_block=reads_t.shape[0], state_dtype="int16", unroll=8,
        interpret=True,
    )
    got = cuda_score.score_grid_diag(reads_t, refs_t, *PARAMS, state_dtype="int16")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert not got[5].any()  # the empty read


@pytest.mark.parametrize("match", [31, 32])
def test_plain_scores_a_read_equal_to_its_ref_at_the_boundary(match):
    """A 1,024 bp read against itself scores match x 1,024: 31,744 (the
    s16x2 form's largest at this width) and 32,768 (past int16)."""
    rng = np.random.default_rng(match + 100)
    (read,) = _seqs(rng, [1024])
    params = (match, -3, -4)
    reads_t, refs_t = _grid([read], [read])
    got = int(cuda_score.score_grid_diag(reads_t, refs_t, *params)[0, 0])
    assert got == match * 1024
    assert got == oracle.opt_alignments(read, read, ScoringScheme(*params))[0]
    assert got == int(np.asarray(jax_score_grid(reads_t.numpy(), refs_t.numpy(), *params))[0, 0])


def _reads_129_150(rng):
    """Reads of 80-128 bp and 129-150 bp (each group's longest exactly 128
    and 150 bp), an empty read among them."""
    return _seqs(rng, list(rng.integers(80, 128, 6)) + [128, 150] + list(rng.integers(129, 150, 5))) + [""]


@pytest.mark.parametrize("kernel, fn", [("diag", "score_grid_diag"), ("row", "score_grid_row")])
def test_unpacked_dispatch_passes_each_group_at_its_longest_read(kernel, fn, monkeypatch):
    """The backend's unpacked dispatch hands K4 (K5) each read group at the
    width of its longest read: reads of 129-150 bp at 150, not their
    bucket's 256; the grouping and the totals stay as they were."""
    widths = []
    real = getattr(batch_backend, fn)

    def spy(reads_u8, refs_u8, *args, **kw):
        widths.append(reads_u8.shape[1])
        return real(reads_u8, refs_u8, *args, **kw)

    monkeypatch.setattr(batch_backend, fn, spy)
    rng = np.random.default_rng(3)
    reads = _reads_129_150(rng)
    refs = _seqs(rng, [300, 20, 1, 700])
    kw = dict(pack_reads=False) if kernel == "diag" else dict(kernel="row")
    backend = TorchBatchBackend(AlignConfig(ref_dir=".", in_dir=".", out_dir=".", **kw), "cpu")
    totals = backend.totals(reads, refs)
    assert sorted(set(widths)) == [128, 150]
    want = cuda_score.score_grid_diag_plain(*_grid(reads, refs, 256), *PARAMS).sum(dim=0, dtype=torch.int64)
    np.testing.assert_array_equal(totals, want.numpy())


def test_unpacked_totals_and_report_match_jax(tmp_path):
    """totals and a report of reads of 80-150 bp with ``pack_reads=False``
    equal the JAX ``BatchBackend`` and ``swtpu``'s report."""
    rng = np.random.default_rng(5)
    reads = _reads_129_150(rng)
    refs = _seqs(rng, [400, 150, 1, 90, 260])
    refs[1] = reads[7]  # the 150 bp read scores 750 here
    backend = TorchBatchBackend(AlignConfig(ref_dir=".", in_dir=".", out_dir=".", pack_reads=False), "cpu")
    jax_backend = BatchBackend(JaxAlignConfig(ref_dir=".", in_dir=".", out_dir=".", pack_reads=False))
    np.testing.assert_array_equal(backend.totals(reads, refs), jax_backend.totals(reads, refs))

    (tmp_path / "refs").mkdir()
    (tmp_path / "inputs").mkdir()
    (tmp_path / "refs" / "r.rna.fna").write_text("\n".join(f">gi|{j}|s{j}\n{s}" for j, s in enumerate(refs)) + "\n")
    (tmp_path / "inputs" / "input1.fa").write_text("\n".join(reads) + "\n")

    def config(tag, cls):
        return cls(ref_dir=str(tmp_path / "refs"), in_dir=str(tmp_path / "inputs"),
                   out_dir=str(tmp_path / f"out_{tag}"), pack_reads=False)

    def strip(path):
        return [l for l in open(path).read().splitlines() if "Execution Time" not in l]

    want = strip(jax_run_pipeline(config("jax", JaxAlignConfig))[0])
    assert strip(run_pipeline(config("torch", AlignConfig), device="cpu")[0]) == want


def test_no_public_function_takes_a_form():
    """K4's form follows from the data alone: ``score_grid_diag`` keeps its
    signature, and no public function of ops/cuda_score.py takes a form."""
    for name, fn in inspect.getmembers(cuda_score, inspect.isfunction):
        if fn.__module__ == cuda_score.__name__ and not name.startswith("_"):
            assert "form" not in inspect.signature(fn).parameters, name
    assert list(inspect.signature(cuda_score.score_grid_diag).parameters) == [
        "reads_u8", "refs_u8", "match", "mismatch", "gap", "state_dtype", "window_mode",
    ]
    cuda_score.reset_launches()
    assert cuda_score.K4_FORMS == {"s16x2": 0, "int32": 0}
    with pytest.raises(ValueError):
        cuda_score._score_grid_diag(*_grid(["ACGT"], ["ACGT"]), *PARAMS, form="int8")
