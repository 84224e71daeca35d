"""K6's plain version against the JAX step chains (Pallas interpret mode,
tiny shapes): ``ops/microbench.py:_roofline_kernel`` and
``experiments/triangle_timepack.py:_chain_kernel``, exactly; and the
port's ``step_roofline``."""

import functools
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from sparksmithwaterman_tpu.ops.microbench import _roofline_kernel
from sparksmithwaterman_tpu_torch.ops import cuda_score
from sparksmithwaterman_tpu_torch.ops.microbench import step_roofline
from sparksmithwaterman_tpu_torch.ops.packing import START_BIT

torch.set_num_threads(1)

RB, M, STEPS = 8, 128, 256


def _chain_module():
    path = pathlib.Path(__file__).resolve().parents[1] / "experiments" / "triangle_timepack.py"
    spec = importlib.util.spec_from_file_location("triangle_timepack", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _reads(seed, starts):
    """The JAX microbench's codes (2-5), with START_BIT on about one lane
    in twelve when ``starts``."""
    rng = np.random.default_rng(seed)
    reads = rng.integers(2, 6, size=(RB, M)).astype(np.int32)
    if starts:
        reads[rng.random((RB, M)) < 1 / 12] |= START_BIT
    return reads


def _pallas(kernel, reads):
    out = pl.pallas_call(
        kernel, out_shape=jax.ShapeDtypeStruct(reads.shape, jnp.int32), interpret=True
    )(jnp.asarray(reads))
    return np.asarray(out)


def _k6(reads, unroll, masked):
    return cuda_score.step_chain_best(
        torch.from_numpy(reads), steps=STEPS, unroll=unroll, match=5, mismatch=-3, gap=-4, masked=masked
    ).numpy()


@pytest.mark.parametrize("unroll", [8, 7], ids=["even_unroll", "odd_unroll"])
@pytest.mark.parametrize("starts", [False, True], ids=["no_starts", "starts"])
def test_step_chain_matches_roofline_kernel(unroll, starts):
    """#12: with an odd unroll each body's last step is run, not counted."""
    reads = _reads(unroll, starts)
    kernel = functools.partial(_roofline_kernel, steps=STEPS, match=5, mismatch=-3, gap=-4, unroll=unroll)
    np.testing.assert_array_equal(_k6(reads, unroll, masked=False), _pallas(kernel, reads))


@pytest.mark.parametrize(
    "masked, unroll, starts",
    [(True, 8, False), (True, 7, True), (True, 1, True), (False, 8, True)],
    ids=["masked_even", "masked_odd_starts", "masked_unroll1", "unmasked_starts"],
)
def test_step_chain_matches_time_packing_chain(masked, unroll, starts):
    """#13: the moving boundary zeroes lanes >= (step & 1023), and every
    step of a body counts."""
    reads = _reads(10 + unroll, starts)
    kernel = functools.partial(_chain_module()._chain_kernel, steps=STEPS, unroll=unroll, masked=masked)
    np.testing.assert_array_equal(_k6(reads, unroll, masked), _pallas(kernel, reads))


def test_step_chain_outputs_are_not_uniform():
    """The parity cases above compare more than one repeated value: start
    lanes cut the circular chain into segments whose bests differ lane to
    lane, and without them the moving boundary changes the bests."""
    starts = _reads(3, starts=True)
    assert len(np.unique(_k6(starts, 8, masked=False))) > 10
    assert len(np.unique(_k6(starts, 8, masked=True))) > 10
    wraps = _reads(3, starts=False)
    assert not np.array_equal(_k6(wraps, 8, masked=False), _k6(wraps, 8, masked=True))


def test_step_roofline_on_cpu_gives_a_rate():
    rate = step_roofline(rb=RB, m=M, steps=64, iters=1, unroll=8, device="cpu")
    assert rate > 0


def test_step_chain_rejects_unroll_one_and_bad_rows():
    reads = torch.from_numpy(_reads(0, starts=False))
    with pytest.raises(ValueError, match="unroll"):
        cuda_score.step_chain_best(reads, steps=STEPS, unroll=1)
    with pytest.raises(ValueError, match="steps"):
        cuda_score.step_chain_best(reads, steps=-1, unroll=8)
    with pytest.raises(ValueError, match="int32"):
        cuda_score.step_chain_best(reads.to(torch.int64), steps=STEPS, unroll=8)
    assert cuda_score.step_chain_best(reads, steps=5, unroll=8).abs().sum() == 0  # no whole body


@pytest.mark.gpu
def test_step_chain_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    reads = torch.from_numpy(_reads(4, starts=True)).cuda()
    for unroll, masked in ((8, False), (7, False), (7, True)):
        got = cuda_score.step_chain_best(reads, steps=STEPS, unroll=unroll, masked=masked)
        want = cuda_score.step_chain_best_plain(reads, STEPS, unroll, 5, -3, -4, masked)
        assert torch.equal(got, want)
