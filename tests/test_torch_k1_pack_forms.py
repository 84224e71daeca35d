"""K1's packs, one form a pack: the batch backend groups a file's reads by
the form K1 takes for each read alone (``cuda_score.k1k4_form`` at the
read's own lane tier) and packs each group at its own longest read's
tier, so that one read past the 16-bit rule never puts the others into
the int32 form; a wide pack pads its rows only to its form's pairing.

Here on the CPU (the kernels' plain versions): the packs of a file shaped
like the long-read cell, totals against the JAX row recurrence on the
batch backend and on a sharded one whose packs sit at two lane tiers,
files of one form packed as the single-pack rule packed them, and the
``flush`` span's ``cells_s16x2``.  The wide kernels' launches of few
rows run only on the card (``chip_smoke.py`` [14]).  Tolerance 0
throughout: scores are integers.
"""

import numpy as np
import pytest
import torch

from sparksmithwaterman_tpu.ops.recurrence import score_grid as jax_score_grid
from sparksmithwaterman_tpu_torch.config import AlignConfig, ScoringScheme
from sparksmithwaterman_tpu_torch.io.fasta import READ_PAD, REF_PAD, encode_batch
from sparksmithwaterman_tpu_torch.models.batch_backend import _INT32_SAFE, TorchBatchBackend
from sparksmithwaterman_tpu_torch.ops import cuda_score
from sparksmithwaterman_tpu_torch.ops.packing import START_BIT, pack_reads
from sparksmithwaterman_tpu_torch.parallel import engine
from sparksmithwaterman_tpu_torch.parallel.engine import ShardedBackend
from sparksmithwaterman_tpu_torch.parallel.mesh import build_mesh
from sparksmithwaterman_tpu_torch.utils import profiling

torch.set_num_threads(1)

PARAMS = (5, -3, -4)
_BASES = np.array(list("ACGT"))
# The long-read cell's file (swbench.gen.read_lengths on its 64 Mbp tree):
# 19 reads of 1,067-5,518 bp inside the 16-bit rule, one of 8,039 bp past it.
LONG_READS = [1067, 1154, 1243, 1337, 1435, 1538, 1649, 1768, 1897, 2038, 2195, 2371, 2571, 2804, 3082, 3425,
              3871, 4497, 5518, 8039]


def _seqs(rng, lens):
    return ["".join(rng.choice(_BASES, size=int(n))) for n in lens]


def _backend(params=PARAMS, **kw):
    return TorchBatchBackend(AlignConfig(ref_dir="", in_dir="", out_dir="", scoring=ScoringScheme(*params), **kw),
                             "cpu")


def _r_limit(params=PARAMS):
    return max(1, _INT32_SAFE // params[0])


def _own_form(backend, read):
    """The form K1 takes for one read alone, at its own lane tier."""
    n = max(1, len(read))
    m = max(2 * backend.read_bucket, 128)
    while m < n:
        m *= 2
    return cuda_score.k1k4_form(m, *backend._params, longest=n)


def _single_packs(backend, reads, r_limit):
    """The packs of the rule before packs were split by form: every read at
    the longest read's tier, rows in blocks of eight, chunks of at most
    r_limit bp in read order."""
    m_pack = max(2 * backend.read_bucket, 128)
    while m_pack < max(len(r) for r in reads):
        m_pack *= 2
    budget = max(m_pack, r_limit)
    chunks, chunk, bp = [], [], 0
    for i, read in enumerate(reads):
        if chunk and bp + max(1, len(read)) > budget:
            chunks.append(chunk)
            chunk, bp = [], 0
        chunk.append(i)
        bp += max(1, len(read))
    chunks.append(chunk)
    out = []
    for idx in chunks:
        packed, start = pack_reads([reads[i] for i in idx], m_pack)
        out.append(dict(m_pack=m_pack, packed=packed, start_idx=start.astype(np.int64),
                        longest=max(1, max(len(reads[i]) for i in idx)), read_idx=idx))
    return out


def _jax_totals(reads, refs, params=PARAMS):
    m = max(map(len, reads))
    n = max(map(len, refs))
    best = jax_score_grid(encode_batch(reads, m, READ_PAD), encode_batch(refs, n, REF_PAD), *params)
    return np.asarray(best).astype(np.int64).sum(axis=0)


def _long_file(rng, lens, refs):
    """Reads of the given lengths, each holding a copy of one reference (or
    its prefix) at a random offset, so that totals are large."""
    reads = []
    for k, n in enumerate(lens):
        ref = refs[k % len(refs)][:n]
        at = int(rng.integers(0, n - len(ref) + 1))
        pad = _seqs(rng, [n - len(ref)])[0]
        reads.append(pad[:at] + ref + pad[at:])
    return reads


def test_long_read_file_packs_one_form_each():
    """The long-read cell's file: one int32 pack of one row holding only the
    8,039 bp read, one s16x2 pack of an even number of rows (six) holding
    the other 19; every read's own form is its pack's, and each pack's form
    is the one K1's wrapper takes for it."""
    backend = _backend()
    reads = _seqs(np.random.default_rng(0), LONG_READS)
    packs = backend._pack_chunks(reads, _r_limit())
    by_form = {p["form"]: p for p in packs}
    assert len(packs) == 2 and set(by_form) == {"s16x2", "int32"}
    wide32, wide16 = by_form["int32"], by_form["s16x2"]
    assert wide32["read_idx"] == [19] and wide32["rows"] == 1 and wide32["longest"] == 8039
    assert wide16["rows"] == 6 and wide16["rows"] % 2 == 0 and wide16["longest"] == 5518
    assert sorted(wide16["read_idx"]) == list(range(19)) and wide16["read_bp"] == 45460
    for p in packs:
        assert p["m_pack"] == 8192 and p["packed"].shape == (p["rows"], 8192)
        assert p["form"] == cuda_score.k1k4_form(p["m_pack"], *PARAMS, longest=p["longest"])
        assert all(_own_form(backend, reads[i]) == p["form"] for i in p["read_idx"])
    assert backend._s16x2_read_bp(reads) == 45460
    assert round(backend._s16x2_read_bp(reads) / sum(LONG_READS), 3) == 0.850


def test_wide_packs_pad_only_to_their_form():
    """Three rows of 16-bit reads (short ones among them, which join their
    group's 4,096-lane tier) pad to four, a lone int32 row to none; rows
    of one pass keep blocks of eight."""
    backend = _backend()
    reads = _seqs(np.random.default_rng(1), [3500, 2600, 1800, 1067, 8039, 120, 90])
    packs = {p["form"]: p for p in backend._pack_chunks(reads, _r_limit())}
    assert (packs["s16x2"]["m_pack"], packs["s16x2"]["rows"]) == (4096, 4)
    assert (packs["int32"]["m_pack"], packs["int32"]["rows"]) == (8192, 1)
    pad = packs["s16x2"]["packed"][3].numpy()
    assert pad[0] == READ_PAD | START_BIT and (pad[1:] == READ_PAD).all()
    (short,) = backend._pack_chunks(reads[5:], _r_limit())
    assert (short["form"], short["m_pack"], short["rows"]) == ("s16x2", 256, 8)


@pytest.mark.parametrize("case", ["batch-long", "sharded_refs-two_tiers", "sharded_reads-two_tiers"])
def test_totals_of_two_forms_match_jax(case, monkeypatch):
    """Totals over a file of both forms equal the JAX recurrence's: on the
    batch backend with the long-read cell's shape (both packs 8,192 lanes
    wide), and on sharded backends of two CPU entries whose packs sit at
    two tiers (4,096 and 8,192 lanes), each pack's reference chunks planned
    at its own rows and lanes."""
    plans, launched = [], set()
    real_chunks, real_k1 = engine.ref_chunks, engine.lane_best_packed_varlen
    monkeypatch.setattr(engine, "ref_chunks", lambda out_per_ref, *a: plans.append(out_per_ref)
                        or real_chunks(out_per_ref, *a))
    monkeypatch.setattr(engine, "lane_best_packed_varlen", lambda packed, *a, **k: launched.add(packed.shape)
                        or real_k1(packed, *a, **k))
    kind, shape = case.split("-")
    rng = np.random.default_rng(len(case))
    refs = _seqs(rng, [260, 1, 90])
    lens = [1067, 2600, 5518, 8039] if shape == "long" else [3500, 2600, 1800, 1067, 8039]
    reads = _long_file(rng, lens, refs)
    if kind == "batch":
        backend = _backend()
    else:
        mesh = (2, 1) if kind == "sharded_refs" else (1, 2)
        config = AlignConfig(ref_dir="", in_dir="", out_dir="", strategy=kind.replace("sharded", "shard"))
        backend = ShardedBackend(config, build_mesh(mesh, devices=["cpu"] * 2), device="cpu")
    packs = backend._pack_chunks(reads, _r_limit())
    tiers = {p["m_pack"] for p in packs}
    assert {p["form"] for p in packs} == {"s16x2", "int32"}
    assert tiers == ({8192} if shape == "long" else {4096, 8192})
    np.testing.assert_array_equal(backend.totals(reads, refs), _jax_totals(reads, refs))
    if kind != "batch":
        assert {m for _, m in launched} == {4096, 8192} and set(plans) == {r * m for r, m in launched}


@pytest.mark.parametrize("case", ["short_reads", "wide_match20"])
def test_files_of_one_form_pack_as_before(case):
    """A file whose reads all take one form packs as the single-pack rule
    packed it: short reads (one pass, 16 bits) in several chunks array for
    array; the 1,500 bp read at match 20 (20 x 2,048 past int16, 20 x 1,500
    inside) with its short reads in 2,048-lane rows, array for array up to
    the all-pad rows past the even row count, which the wide s16x2 pack no
    longer carries."""
    rng = np.random.default_rng(4)
    if case == "short_reads":
        params, reads, r_limit = PARAMS, _seqs(rng, rng.integers(80, 151, 600)), 20_000
    else:
        params = (20, -3, -4)
        reads = _seqs(rng, [90] * 12 + [300] * 3 + [1500])
        r_limit = _r_limit(params)
    backend = _backend(params)
    new, old = backend._pack_chunks(reads, r_limit), _single_packs(backend, reads, r_limit)
    assert len(new) == len(old) > (1 if case == "short_reads" else 0)
    for p, q in zip(new, old):
        assert p["read_idx"] == q["read_idx"]
        assert (p["m_pack"], p["longest"]) == (q["m_pack"], q["longest"])
        np.testing.assert_array_equal(p["start_idx"].numpy(), q["start_idx"])
        rows = p["rows"]
        np.testing.assert_array_equal(p["packed"].numpy(), q["packed"][:rows])
        if case == "short_reads":
            assert rows == q["packed"].shape[0] and p["form"] == "s16x2"
        else:
            assert p["form"] == "s16x2" and rows % 2 == 0 and rows < q["packed"].shape[0]
            extra = q["packed"][rows:]
            assert (extra[:, 0] == READ_PAD | START_BIT).all() and (extra[:, 1:] == READ_PAD).all()


@pytest.fixture
def tracer():
    profiling.reset()
    profiling.enable()
    try:
        yield profiling
    finally:
        profiling.disable()
        profiling.reset()


@pytest.mark.parametrize("pack", [True, False])
def test_flush_span_counts_the_16bit_cells(tracer, pack):
    """The ``flush`` span carries ``cells_s16x2``, the real cells K1 scores
    in its 16-bit form: at match 40 the 900 bp read's 1,024-lane rows are
    past int16 and the short reads' 256-lane rows inside, so 220 of the
    1,120 read bp; none on the unpacked path, which K1 does not score."""
    rng = np.random.default_rng(6)
    params = (40, -3, -4)
    reads = _seqs(rng, [100, 120, 900])
    refs = _seqs(rng, [50, 70])
    backend = _backend(params, pack_reads=pack)
    np.testing.assert_array_equal(backend.totals(reads, refs), _jax_totals(reads, refs, params))
    (flush,) = [s for s in tracer.records().spans if s.name == "flush"]
    assert flush.attrs["cells"] == 1120 * 120
    assert flush.attrs["cells_s16x2"] == (220 * 120 if pack else 0)
    if pack:
        assert sorted((p["form"], p["m_pack"], p["rows"]) for p in backend._pack_chunks(reads, _r_limit(params))) \
            == [("int32", 1024, 8), ("s16x2", 256, 8)]
