"""K7's plain version against the JAX packed step variants
(``experiments/packed_step_variants.py:make_kernel``, Pallas interpret
mode, tiny shapes), exactly for A-D.  The JAX script cannot trace E (its
step has no branch for it), so E is held to A: its segmented suffix max
equals A."""

import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from sparksmithwaterman_tpu.io.fasta import REF_PAD, encode_batch
from sparksmithwaterman_tpu.ops.pallas_score import _diag_windows, plan_diag
from sparksmithwaterman_tpu_torch.ops import cuda_score
from sparksmithwaterman_tpu_torch.ops.packing import pack_reads

torch.set_num_threads(1)

ROWS, M, C, N, UNROLL = 8, 128, 2, 64, 16
_BASES = np.array(list("ACGT"))


def _variants_module():
    path = pathlib.Path(__file__).resolve().parents[1] / "experiments" / "packed_step_variants.py"
    spec = importlib.util.spec_from_file_location("packed_step_variants", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _inputs(seed=0):
    """Packed rows of several reads each (start lanes inside rows, a
    trailing pad segment) against C random references."""
    rng = np.random.default_rng(seed)
    reads = ["".join(rng.choice(_BASES, size=int(n))) for n in rng.integers(10, 50, size=20)]
    packed, _ = pack_reads(reads, M, row_multiple=ROWS)
    refs = ["".join(rng.choice(_BASES, size=N)) for _ in range(C)]
    return packed[:ROWS], encode_batch(refs, N, REF_PAD)


def _pallas(variant, packed, refs_enc):
    diags = M + N - 1
    _, t_pad = plan_diag(ROWS, M, N, UNROLL)
    windows = _diag_windows(jnp.asarray(refs_enc).astype(jnp.int32), M, t_pad)
    out = pl.pallas_call(
        _variants_module().make_kernel(variant, diags, UNROLL),
        out_shape=jax.ShapeDtypeStruct((C, ROWS, M), jnp.int32),
        grid=(C, 1),
        in_specs=[
            pl.BlockSpec((ROWS, M), lambda ci, ri: (ri, 0), memory_space=pltpu.VMEM),
            pl.BlockSpec((1, t_pad, M), lambda ci, ri: (ci, 0, 0), memory_space=pltpu.VMEM),
        ],
        out_specs=pl.BlockSpec((1, ROWS, M), lambda ci, ri: (ci, ri, 0), memory_space=pltpu.VMEM),
        interpret=True,
    )(jnp.asarray(packed), windows)
    return np.asarray(out)


def _k7(packed, refs_enc, variant):
    return cuda_score.step_variant_best(
        torch.from_numpy(packed), torch.from_numpy(refs_enc), variant=variant, unroll=UNROLL,
        match=5, mismatch=-3, gap=-4,
    ).numpy()


@pytest.mark.parametrize("variant", ["A", "B", "C", "D"])
def test_step_variant_matches_pallas(variant):
    packed, refs_enc = _inputs()
    np.testing.assert_array_equal(_k7(packed, refs_enc, variant), _pallas(variant, packed, refs_enc))


def test_variant_e_suffix_max_equals_a():
    packed, refs_enc = _inputs(1)
    e = torch.from_numpy(_k7(packed, refs_enc, "E"))
    a = _k7(packed, refs_enc, "A")
    start = torch.from_numpy(packed) >= 256
    np.testing.assert_array_equal(cuda_score.segmented_suffix_max(e, start).numpy(), a)
    assert not np.array_equal(e.numpy(), a)  # E really skipped the suffix max


def test_variants_b_and_d_are_not_smith_waterman():
    """A and C agree; B (lane 0 only) and D (the wrap) leak scores across
    read boundaries, so on rows of several reads they differ from A."""
    packed, refs_enc = _inputs(2)
    a = _k7(packed, refs_enc, "A")
    np.testing.assert_array_equal(_k7(packed, refs_enc, "C"), a)
    assert not np.array_equal(_k7(packed, refs_enc, "B"), a)
    assert not np.array_equal(_k7(packed, refs_enc, "D"), a)


def test_variant_steps_and_arguments():
    assert cuda_score.variant_steps(256, 1024, 16) == 1280
    assert cuda_score.variant_steps(128, 64, 16) == 192
    assert cuda_score.variant_steps(128, 64, 7) == 196
    packed, refs_enc = _inputs()
    with pytest.raises(ValueError, match="variant"):
        _k7(packed, refs_enc, "F")
    with pytest.raises(ValueError, match="unroll"):
        cuda_score.step_variant_best(torch.from_numpy(packed), torch.from_numpy(refs_enc), variant="A", unroll=0)


@pytest.mark.gpu
def test_step_variants_match_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    packed, refs_enc = (torch.from_numpy(a).cuda() for a in _inputs())
    for variant in cuda_score.STEP_VARIANTS:
        got = cuda_score.step_variant_best(packed, refs_enc, variant=variant, unroll=UNROLL)
        want = cuda_score.step_variant_best_plain(packed, refs_enc, variant, UNROLL, 5, -3, -4)
        assert torch.equal(got, want)
