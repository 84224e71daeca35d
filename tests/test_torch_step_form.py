"""K6's and K7's two forms: the rule that admits the 16-bit form
(``cuda_score.step_form``) at both sides of each of its edges, the plain
versions on inputs at the admitted edge held exactly to the JAX step
chains (Pallas interpret mode, tiny shapes), wrapped 16-bit models of the
two s16x2 kernels' arithmetic, and the bench's roofline leg in K4's form.

The kernels themselves run only on the card (``chip_smoke.py`` [0],
[11]-[13]); here the models stand for them: each is exact where the rule
admits s16x2 and wrong one step past the edge.
"""

import functools

import numpy as np
import pytest
import torch
from test_torch_microbench import _chain_module, _pallas as _pallas_chain
from test_torch_step_variants import C as VC, M as VM, N as VN, ROWS as VROWS, UNROLL as VUNROLL
from test_torch_step_variants import _pallas as _pallas_variant

from sparksmithwaterman_tpu.ops.microbench import _roofline_kernel
from sparksmithwaterman_tpu_torch import bench
from sparksmithwaterman_tpu_torch.io.fasta import REF_PAD
from sparksmithwaterman_tpu_torch.ops import cuda_score
from sparksmithwaterman_tpu_torch.ops.microbench import roofline_reads
from sparksmithwaterman_tpu_torch.ops.packing import START_BIT

torch.set_num_threads(1)

step_form = cuda_score.step_form


def _wrap16(x):
    """x as a 16-bit two's complement lane: what a half of an s16x2
    register holds after an add that does not saturate."""
    return ((x + 32768) & 0xFFFF) - 32768


def _k6_model(reads, steps, unroll, match, mismatch, gap):
    """``step_chain_s16x2_kernel`` unmasked, per half: H = c1 of the step
    before, U = the shifted term of the step before, every add wrapping at
    16 bits (``__vadd2``, ``__viaddmax_s16x2_relu``)."""
    r = torch.from_numpy(reads).long()
    sub = torch.where((r & 255) == (r[:1] & 255), match, mismatch)
    keep = (r < START_BIT).long()
    h_prev = torch.zeros_like(r)
    u = torch.zeros_like(r)
    best = torch.zeros_like(r)
    skip = unroll - 1 if unroll % 2 else -1
    for s in range(steps // unroll * unroll):
        up = torch.roll(h_prev, 1, dims=1) * keep
        h = torch.clamp_min(torch.maximum(_wrap16(u + sub), _wrap16(torch.maximum(up, h_prev) + gap)), 0)
        if s % unroll != skip:
            best = torch.maximum(best, h)
        u, h_prev = up, h
    return best.numpy()


def _k7_model(packed, refs, unroll, match, mismatch, gap):
    """``step_variant_s16x2_kernel`` in variant D on rows 2w (low half) and
    2w + 1 (high half) of a 32-bit register: the substitution is one
    32-bit multiply-add, U + e * (match - mismatch) with e 0 or 1 a half,
    whose low half carries into the high one if it passes 65,535; then each
    half adds mismatch and the gap term wrapping at 16 bits."""
    rows, m = packed.shape
    n = refs.shape[1]
    lo, hi = (torch.from_numpy(packed[k::2]).long() & 255 for k in (0, 1))
    k_sub = match - mismatch
    h = torch.zeros((2,) + lo.shape, dtype=torch.int64)
    u = torch.zeros_like(h)
    best = torch.zeros_like(h)
    ref = torch.from_numpy(refs[0]).long()
    for d in range(cuda_score.variant_steps(m, n, unroll)):
        j = d - torch.arange(m)
        win = torch.where((j >= 0) & (j < n), ref[j.clamp(0, n - 1)], REF_PAD)
        e = torch.stack([(lo == win).long(), (hi == win).long()])
        v32 = ((u[0] & 0xFFFF) | (u[1] & 0xFFFF) << 16) + (e[0] | e[1] << 16) * k_sub
        v = torch.stack([v32 & 0xFFFF, (v32 >> 16) & 0xFFFF])
        up = torch.roll(h, 1, dims=2)
        new = torch.clamp_min(torch.maximum(_wrap16(v + mismatch), _wrap16(torch.maximum(up, h) + gap)), 0)
        best = torch.maximum(best, new)
        u, h = up, new
    return torch.stack([best[0], best[1]], 1).reshape(rows, m).numpy()


@pytest.mark.parametrize("steps, form", [(14, "s16x2"), (16, "int32")], ids=["edge", "one_past"])
def test_roofline_kernel_at_the_steps_edge(steps, form):
    """K6 on the JAX microbench's rows (no start bit): row 0 compares with
    itself and gains match every two steps around the ring, so
    ceil(S / 2) x match is reached.  4,681 x 7 = 32,767: 14 steps are s16x2
    and exact in 16 bits; 16 steps are int32, and 16 bits would wrap."""
    match, mismatch, gap = 4681, -3, -4
    reads = np.random.default_rng(7).integers(2, 6, size=(8, 128)).astype(np.int32)
    assert step_form(128, steps, match, mismatch, gap) == form
    assert cuda_score.k6_form(torch.from_numpy(reads), steps, match, mismatch, gap, False) == form
    kernel = functools.partial(_roofline_kernel, steps=steps, match=match, mismatch=mismatch, gap=gap, unroll=2)
    plain = cuda_score.step_chain_best(torch.from_numpy(reads), steps=steps, unroll=2, match=match,
                                       mismatch=mismatch, gap=gap).numpy()
    np.testing.assert_array_equal(plain, _pallas_chain(kernel, reads))
    assert plain.max() == match * (steps // 2)
    model = _k6_model(reads, steps, 2, match, mismatch, gap)
    if form == "s16x2":
        np.testing.assert_array_equal(model, plain)
    else:
        assert not np.array_equal(model, plain)


def test_k6_lane0_starts_and_the_masked_bound():
    """With START_BIT on lane 0 of every row no value passes match x m,
    at any length; the masked probe bounds its values only at 1,024 lanes,
    where lane 1,023 is never live."""
    assert step_form(128, 131_072, 5, -3, -4) == "int32"
    assert step_form(128, 131_072, 5, -3, -4, lane0_starts=True) == "s16x2"
    assert step_form(1024, 131_072, 31, -3, -4, lane0_starts=True) == "s16x2"  # 31,744
    assert step_form(1024, 131_072, 32, -3, -4, lane0_starts=True) == "int32"  # 32,768
    assert step_form(1024, 131_072, 5, -3, -4, masked=True) == "s16x2"
    assert step_form(1024, 131_072, 32, -3, -4, masked=True) == "int32"
    assert step_form(256, 131_072, 5, -3, -4, masked=True) == "int32"
    assert step_form(256, 13_106, 5, -3, -4, masked=True) == "s16x2"  # 5 x 6,553 = 32,765
    starts = torch.from_numpy(roofline_reads(6, 128, lane0_starts=True))
    assert cuda_score.k6_form(starts, 131_072, 5, -3, -4, False) == "s16x2"
    assert cuda_score.k6_form(starts, 131_072, 5, -3, -4, False, starts=False) == "int32"
    starts[3, 0] &= START_BIT - 1
    assert not cuda_score.lane0_starts(starts) and cuda_score.lane0_starts(starts[:0])
    assert cuda_score.k6_form(starts, 131_072, 5, -3, -4, False) == "int32"


def test_chain_kernel_masked_bound_holds_at_1024_lanes_only():
    """``_chain_kernel`` (5/-3/-4) in interpret mode against the plain
    version: at 1,024 lanes the masked chain's best stays within 5 x 1,024
    over several boundary blocks; at 256 lanes it rides the ring from one
    block into the next and passes 5 x 256."""
    for m, steps in ((1024, 2200), (256, 2048)):
        reads = np.random.default_rng(m).integers(2, 6, size=(2, m)).astype(np.int32)
        kernel = functools.partial(_chain_module()._chain_kernel, steps=steps, unroll=8, masked=True)
        plain = cuda_score.step_chain_best(torch.from_numpy(reads), steps=steps, unroll=8, masked=True).numpy()
        np.testing.assert_array_equal(plain, _pallas_chain(kernel, reads))
        if m == 1024:
            assert plain.max() <= 5 * m
        else:
            assert plain.max() > 5 * m
            assert step_form(m, 131_072, 5, -3, -4, masked=True) == "int32"


def test_k7_rule_reads_no_data():
    """At the probe's shape (256 lanes x refs of 1,024 bp, 1,280 steps) the
    bound 5 x 640 = 3,200 admits A, B, D and E; C never; D and A at a
    reference long enough to pass 32,767, B at any length."""
    steps = cuda_score.variant_steps(256, 1024, 16)
    assert steps == 1280
    for v in "ABDE":
        assert step_form(256, steps, 5, -3, -4, variant=v) == "s16x2"
    assert step_form(256, steps, 5, -3, -4, variant="C") == "int32"
    assert step_form(32, 2, 0, 0, 0, variant="C") == "int32"
    edge = cuda_score.variant_steps(256, 12_849, 16)  # 13,104 steps: 5 x 6,552 = 32,760
    past = cuda_score.variant_steps(256, 12_865, 16)  # 13,120 steps: 5 x 6,560 = 32,800
    for v in "ADE":
        assert step_form(256, edge, 5, -3, -4, variant=v) == "s16x2"
        assert step_form(256, past, 5, -3, -4, variant=v) == "int32"
    for n in (12_865, 1 << 20):
        assert step_form(256, cuda_score.variant_steps(256, n, 16), 5, -3, -4, variant="B") == "s16x2"
    assert step_form(1024, past, 32, -3, -4, variant="B") == "int32"  # 32 x 1,024
    with pytest.raises(ValueError, match="lane0_starts is K6's"):
        step_form(256, past, 5, -3, -4, variant="A", lane0_starts=True)


@pytest.mark.parametrize("n, form", [(31, "s16x2"), (32, "int32")], ids=["edge", "one_past"])
def test_k7_16bit_model_at_the_edge(n, form):
    """Variant D, every lane matching its reference column: the best is
    1,057 x min(n, ceil(S / 2)), 32,767 at n = 31 (S = 62).  With mismatch
    -32,768 the substitution's multiply-add then reaches 65,535 in a half
    and carries nothing; one column more, and it carries and wraps."""
    match, mismatch, gap = 1057, -32768, -1
    packed = np.full((4, 32), 2, np.int32)
    packed[1::2, 5::7] = 3  # the high halves hold other rows
    refs = np.full((1, n), 2, np.uint8)
    steps = cuda_score.variant_steps(32, n, 2)
    assert step_form(32, steps, match, mismatch, gap, variant="D") == form
    plain = cuda_score.step_variant_best(torch.from_numpy(packed), torch.from_numpy(refs), variant="D", unroll=2,
                                         match=match, mismatch=mismatch, gap=gap).numpy()
    assert plain[0].max() == match * n
    model = _k7_model(packed, refs, 2, match, mismatch, gap)
    raw = cuda_score.step_variant_best(torch.from_numpy(packed), torch.from_numpy(refs), variant="E", unroll=2,
                                       match=match, mismatch=mismatch, gap=gap).numpy()[0]
    if form == "s16x2":
        np.testing.assert_array_equal(model, raw)  # no start lanes: D's step is E's, whose bests are raw
    else:
        assert not np.array_equal(model, raw)


def test_k7_plain_matches_make_kernel_at_full_growth():
    """Rows of one code against references of that code, no start lanes:
    every diagonal move gains, the values grow as far as the references
    allow (64 matches), and the plain version equals ``make_kernel`` in
    every variant A-D."""
    packed = np.full((VROWS, VM), 70, np.int32)
    packed[::3, ::5] = 71
    refs = np.full((VC, VN), 70, np.uint8)
    steps = cuda_score.variant_steps(VM, VN, VUNROLL)
    for variant in "ABCD":
        plain = cuda_score.step_variant_best(torch.from_numpy(packed), torch.from_numpy(refs), variant=variant,
                                             unroll=VUNROLL, match=5, mismatch=-3, gap=-4).numpy()
        np.testing.assert_array_equal(plain, _pallas_variant(variant, packed, refs))
        assert plain.max() > 5 * 60
        assert step_form(VM, steps, 5, -3, -4, variant=variant) == ("int32" if variant == "C" else "s16x2")


def test_sign_rules():
    """k1_form's signs: 0 <= match, -32,768 <= mismatch <= 0, -32,768 <=
    gap <= 0, and rows of at most 1,024 lanes."""
    for variant in (None, "A", "B", "D", "E"):
        assert step_form(128, 64, 5, -3, -4, variant=variant) == "s16x2"
        assert step_form(128, 64, 5, 0, 0, variant=variant) == "s16x2"
        assert step_form(128, 64, 5, -32768, -32768, variant=variant) == "s16x2"
        for bad in ((-1, -3, -4), (5, 1, -4), (5, -3, 1), (5, -32769, -4), (5, -3, -32769)):
            assert step_form(128, 64, *bad, variant=variant) == "int32"
        assert step_form(2048, 64, 5, -3, -4, variant=variant) == "int32"
    with pytest.raises(ValueError, match="variant"):
        step_form(128, 64, 5, -3, -4, variant="F")


def test_bench_roofline_restarts_at_lane0_in_k4s_form():
    """The roofline leg's rows restart at lane 0, and K6 takes there the
    form that K4 takes on the kernel leg (128 lanes); the leg refuses a
    scheme under which the two differ.  On the CPU only forms compare."""
    reads = roofline_reads(16, 128, lane0_starts=True)
    assert (reads[:, 0] >= START_BIT).all() and (reads[:, 1:] < START_BIT).all()
    assert (roofline_reads(16, 128) < START_BIT).all()  # the JAX microbench's inputs
    steps = bench.ROOFLINE_STEPS // 64 * 64
    assert step_form(128, steps, *bench.PARAMS, lane0_starts=True) == cuda_score.k1_form(128, *bench.PARAMS)
    assert cuda_score.k6_form(torch.from_numpy(reads), steps, *bench.PARAMS, False) == "s16x2"
    rate, _ = bench.bench_roofline(rb=4, m=32, steps=32, iters=1, unroll=8, repeats=1, device="cpu")
    assert rate > 0
    with pytest.raises(RuntimeError, match="K6 would run s16x2, K4 int32"):
        bench.bench_roofline((300, -3, -4), rb=4, m=128, steps=64, iters=1, unroll=8, repeats=1, device="cpu")
    with pytest.raises(ValueError, match="pass rb"):
        bench.roofline_rows("cpu")


def test_forms_are_checked_and_counted(monkeypatch):
    reads = torch.from_numpy(roofline_reads(4, 128))
    with pytest.raises(ValueError, match="cannot take form 's16x2'"):
        cuda_score._step_chain_best(reads, steps=131_072, unroll=64, form="s16x2")
    with pytest.raises(ValueError, match="cannot take form 's16x2'"):  # the caller's lane-0 reading
        cuda_score._step_chain_best(reads, steps=131_072, unroll=64, form="s16x2", starts=False)

    def no_read(_):
        raise AssertionError("the int32 form read lane 0")

    with monkeypatch.context() as patch:  # an explicit int32 form reads no data (1,000 x 33 > 32,767 >= 1,000 x 32)
        patch.setattr(cuda_score, "lane0_starts", no_read)
        cuda_score._step_chain_best(reads[:, :32], steps=66, unroll=2, match=1000, form="int32")
        with pytest.raises(AssertionError, match="read lane 0"):
            cuda_score._step_chain_best(reads[:, :32], steps=66, unroll=2, match=1000, form="s16x2")
    got = cuda_score._step_chain_best(reads, steps=64, unroll=8, form="int32")
    assert torch.equal(got, cuda_score._step_chain_best(reads, steps=64, unroll=8, form="s16x2"))
    packed = torch.full((2, 32), 3, dtype=torch.int32)
    refs = torch.full((1, 8), 3, dtype=torch.uint8)
    with pytest.raises(ValueError, match="cannot take form 's16x2'"):
        cuda_score._step_variant_best(packed, refs, variant="C", form="s16x2")
    with pytest.raises(ValueError, match="cannot take form 'int16'"):
        cuda_score._step_variant_best(packed, refs, variant="A", form="int16")
    cuda_score.K6_FORMS["s16x2"] = cuda_score.K7_FORMS["int32"] = 3
    cuda_score.reset_launches()
    assert not any(cuda_score.K6_FORMS.values()) and not any(cuda_score.K7_FORMS.values())


@pytest.mark.gpu
def test_s16x2_forms_match_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    cuda_score.reset_launches()
    reads = torch.from_numpy(roofline_reads(7, 128, lane0_starts=True)).cuda()
    for unroll, masked in ((8, False), (7, False), (7, True)):
        want = cuda_score.step_chain_best_plain(reads, 4096, unroll, 5, -3, -4, masked)
        assert torch.equal(cuda_score.step_chain_best(reads, steps=4096, unroll=unroll, masked=masked), want)
        assert torch.equal(cuda_score._step_chain_best(reads, steps=4096, unroll=unroll, masked=masked,
                                                       form="int32"), want)
    packed = torch.from_numpy(np.random.default_rng(0).integers(65, 70, size=(5, 128)).astype(np.int32)).cuda()
    refs = torch.from_numpy(np.random.default_rng(1).integers(65, 70, size=(2, 200)).astype(np.uint8)).cuda()
    for variant in cuda_score.STEP_VARIANTS:
        want = cuda_score.step_variant_best_plain(packed, refs, variant, 16, 5, -3, -4)
        assert torch.equal(cuda_score.step_variant_best(packed, refs, variant=variant), want)
        assert torch.equal(cuda_score._step_variant_best(packed, refs, variant=variant, form="int32"), want)
    assert cuda_score.K6_FORMS == {"s16x2": 3, "int32": 3}
    assert cuda_score.K7_FORMS == {"s16x2": 4, "int32": 6}
