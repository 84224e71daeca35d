"""The port's own tracer (``utils.profiling``): off, it records nothing
and hands out one shared null span; on, ``run_pipeline`` opens its spans
under each input file's span, with a flush's real cells; the sharded
backend's encodes and uploads sit inside its flushes; the self-time and
anchor arithmetic on synthetic records; every launch goes through one
helper that looks its entry up at each call; and on a card, each launch
placed on the host clock no earlier than its enqueue."""

import math
import types

import numpy as np
import pytest
import torch

from sparksmithwaterman_tpu_torch.config import AlignConfig
from sparksmithwaterman_tpu_torch.models.pipeline import run_pipeline
from sparksmithwaterman_tpu_torch.ops import _cuda, cuda_score
from sparksmithwaterman_tpu_torch.utils import profiling

torch.set_num_threads(1)

_BASES = np.array(list("ACGT"))
_KINDS = ("parse", "flush", "encode", "wait", "traceback", "report")


@pytest.fixture
def tracer():
    profiling.reset()
    profiling.enable()
    try:
        yield profiling
    finally:
        profiling.disable()
        profiling.reset()


def _tree(root, rng, n_inputs=2):
    """Two reference files and ``n_inputs`` read files; returns (read bp
    of each input, reference bp)."""
    (root / "refs").mkdir(parents=True)
    (root / "inputs").mkdir()
    ref_bp = 0
    for fi in range(2):
        seqs = ["".join(rng.choice(_BASES, size=int(n))) for n in rng.integers(20, 90, size=5)]
        ref_bp += sum(map(len, seqs))
        (root / "refs" / f"r{fi}.rna.fna").write_text(
            "".join(f">gi|{fi}{j}|t{fi}{j}\n{s}\n" for j, s in enumerate(seqs)))
    read_bp = []
    for k in range(n_inputs):
        reads = ["".join(rng.choice(_BASES, size=int(n))) for n in rng.integers(5, 30, size=4)]
        read_bp.append(sum(map(len, reads)))
        (root / "inputs" / f"input{k + 1}.fa").write_text("\n".join(reads) + "\n")
    return read_bp, ref_bp


def _config(root, **kw):
    return AlignConfig(ref_dir=str(root / "refs"), in_dir=str(root / "inputs"), out_dir=str(root / "out"),
                       read_bucket=8, ref_bucket=8, ref_batch_bp=150, **kw)


def _ancestors(s):
    p = s.parent
    while p is not None:
        yield p
        p = p.parent


def _file_of(s):
    """The ``file`` span above ``s``, or None."""
    return next((p for p in _ancestors(s) if p.name == "file"), None)


def test_off_records_nothing_and_returns_the_shared_null_span(tmp_path):
    profiling.disable()
    profiling.reset()
    assert profiling.span("flush", refs=3) is profiling.NULL_SPAN
    assert profiling.span("wait", on="upload") is profiling.span("file")
    with profiling.span("flush") as s:
        s.set(cells=5)
    assert not s
    _tree(tmp_path, np.random.default_rng(1), n_inputs=1)
    run_pipeline(_config(tmp_path), device="cpu")
    rec = profiling.records()
    assert rec.spans == [] and rec.launches == [] and rec.drift == {}


@pytest.mark.parametrize("pack_reads", [True, False])
def test_pipeline_spans_sit_under_their_file(tmp_path, tracer, pack_reads):
    read_bp, ref_bp = _tree(tmp_path, np.random.default_rng(2))
    run_pipeline(_config(tmp_path, pack_reads=pack_reads), device="cpu")
    spans = tracer.records().spans
    files = [s for s in spans if s.name == "file"]
    assert len(files) == 2 and len({f.file for f in files}) == 2
    assert all(f.parent is None and f.start <= f.end for f in files)
    kinds = {s.name for s in spans}
    assert kinds >= set(_KINDS), kinds
    for s in spans:
        if s.name in _KINDS:
            f = _file_of(s)
            assert f is not None and s.file == f.file and f.start <= s.start <= s.end <= f.end, s
    for s in spans:
        if s.name == "encode":
            assert any(p.name == "flush" for p in _ancestors(s)), s
    assert {s.label for s in spans if s.name == "wait"} >= {"wait:upload", "wait:resolve"}
    assert {s.attrs["branch"] for s in spans if s.name == "traceback"} <= {"windowed", "full"}
    for f, bp in zip(sorted(files, key=lambda f: f.start), read_bp):
        flushes = [s for s in spans if s.name == "flush" and s.file == f.file]
        assert len(flushes) >= 2
        assert sum(s.attrs["cells"] for s in flushes) == bp * ref_bp
        assert sum(s.attrs["ref_bp"] for s in flushes) == ref_bp


def test_sharded_flushes_hold_their_encodes_and_uploads(tmp_path, tracer):
    from sparksmithwaterman_tpu_torch.parallel.engine import ShardedBackend
    from sparksmithwaterman_tpu_torch.parallel.mesh import build_mesh

    _tree(tmp_path, np.random.default_rng(3), n_inputs=1)
    config = _config(tmp_path, strategy="shard_refs")
    backend = ShardedBackend(config, mesh=build_mesh((4, 1), devices=["cpu"] * 4), device="cpu")
    run_pipeline(config, backend=backend, device="cpu")
    spans = tracer.records().spans
    flushes = [s for s in spans if s.name == "flush"]
    assert len(flushes) >= 2
    for f in flushes:
        inside = [s for s in spans if s.parent is f]
        assert {s.label for s in inside} >= {"encode", "wait:upload"}, f
        # split_by_bp, then one encode per card with references
        assert sum(s.name == "encode" for s in inside) >= 2


def _span(name, a, b, parent=None, **attrs):
    s = profiling.Span(profiling.TRACER, name, attrs)
    s.start, s.end, s.parent = a, b, parent
    return s


def test_self_pieces_subtract_each_spans_children():
    f = _span("file", 0.0, 10.0)
    fl = _span("flush", 1.0, 5.0, f)
    enc = _span("encode", 1.5, 2.0, fl)
    w = _span("wait", 3.0, 4.0, fl, on="throttle")
    tb = _span("traceback", 6.0, 7.0, f, branch="full")
    pieces = profiling.self_pieces([enc, w, fl, tb, f])
    by = {}
    for a, b, s in pieces:
        assert a < b
        by[s.label] = by.get(s.label, 0.0) + (b - a)
    assert by == pytest.approx({"file": 5.0, "flush": 2.5, "encode": 0.5, "wait:throttle": 1.0,
                                "traceback:full": 1.0})
    assert sum(by.values()) == pytest.approx(10.0)
    flush_pieces = sorted((a, b) for a, b, s in pieces if s is fl)
    assert flush_pieces == [(1.0, 1.5), (2.0, 3.0), (4.0, 5.0)]


class _Event:
    """A card event at ``t`` seconds of the card's clock."""

    def __init__(self, t):
        self.t = t

    def elapsed_time(self, other):
        return (other.t - self.t) * 1e3


def test_launches_are_placed_on_the_host_clock_through_two_anchors(monkeypatch):
    tr = profiling.Tracer()
    # The card's clock reads 100 s at host 5 s, and runs 1e-5 slow.
    first = profiling.Anchor(_Event(100.0), 5.0)
    last = profiling.Anchor(_Event(100.0 + 20.0 * (1 - 1e-5)), 25.0)
    tr.anchors[0] = first
    monkeypatch.setattr(tr, "anchor", lambda device: last)
    x = profiling.Launch("swt_k", 0, 9.0, None, (_Event(104.0), _Event(104.5)))
    tr.launches.append(x)
    rec = tr.records()
    assert rec.drift == {0: pytest.approx(20.0 * 1e-5)}
    scale = 20.0 / (20.0 * (1 - 1e-5))
    assert x.start == pytest.approx(5.0 + 4.0 * scale)
    assert x.end == pytest.approx(5.0 + 4.5 * scale)
    assert profiling.on_host(first, last, 0.0, 2.0) == 7.0
    assert rec.launches == [x] and math.isnan(profiling.Launch("e", 1, 0.0, None, ()).start)


def test_every_launch_goes_through_one_helper(monkeypatch):
    calls = []
    lib = types.SimpleNamespace(swt_k=lambda *a: calls.append(("k", a)) or 0,
                                swt_error_string=lambda rc: b"refused")
    monkeypatch.setattr(_cuda, "lib", lambda: lib)
    monkeypatch.setitem(cuda_score.LAUNCHES, "fill_walk", 0)
    profiling.disable()
    cuda_score._launch("fill_walk", "swt_k", 1, 2, 0, 0)
    # an entry replaced on the library after import is the one called
    monkeypatch.setattr(lib, "swt_k", lambda *a: calls.append(("wrapped", a)) or 0)
    cuda_score._launch("fill_walk", "swt_k", 3, 0, 0)
    cuda_score._launch("fill_walk", "swt_k", 4, 0, 0, count=False)
    assert [c[0] for c in calls] == ["k", "wrapped", "wrapped"]
    assert cuda_score.LAUNCHES["fill_walk"] == 2
    monkeypatch.setattr(lib, "swt_k", lambda *a: 7)
    with pytest.raises(RuntimeError, match="fill_walk: CUDA error 7"):
        cuda_score._launch("fill_walk", "swt_k", 0, 0)
    assert profiling.records().launches == []


@pytest.mark.gpu
def test_anchored_launches_start_after_their_enqueue_on_card(tracer):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from sparksmithwaterman_tpu_torch.io.fasta import REF_PAD, encode_batch
    from sparksmithwaterman_tpu_torch.ops.packing import pack_reads

    dev = torch.device("cuda")
    rng = np.random.default_rng(4)
    reads = ["".join(rng.choice(_BASES, size=int(n))) for n in rng.integers(80, 150, size=256)]
    refs = ["".join(rng.choice(_BASES, size=int(n))) for n in rng.integers(500, 4000, size=64)]
    packed, _ = pack_reads(reads, 256)
    args = (torch.from_numpy(packed).to(dev), torch.from_numpy(encode_batch(refs, 4000, REF_PAD)).to(dev),
            torch.tensor([len(r) for r in refs], dtype=torch.int32, device=dev))
    with profiling.span("file"):
        for _ in range(20):
            cuda_score.lane_best_packed_varlen(*args, 5, -3, -4)
    torch.cuda.synchronize()
    rec = profiling.records()
    assert len(rec.launches) == 20 and all(x.span is not None for x in rec.launches)
    for x in rec.launches:
        assert x.start >= x.host_t - 50e-6 and x.end > x.start, (x.host_t, x.start, x.end)
    assert all(b.start >= a.end - 50e-6 for a, b in zip(rec.launches, rec.launches[1:]))
    assert abs(rec.drift[0]) < 1e-3


def test_profile_scale_sums_the_records_it_is_given():
    from sparksmithwaterman_tpu_torch.utils.profile_scale import summary

    f = _span("file", 0.0, 4.0)
    flush = _span("flush", 0.5, 2.0, f)
    tb = _span("traceback", 2.5, 3.0, f, branch="windowed")
    launches = []
    for entry, span, a, b in (("swt_k1", flush, 1.0, 2.0), ("swt_k1", flush, 2.0, 2.5), ("swt_k2", tb, 2.6, 2.8)):
        x = profiling.Launch(entry, 0, a - 1e-4, span, ())
        x.start, x.end = a, b
        launches.append(x)
    text = "\n".join(summary(profiling.Records([flush, tb, f], launches, {0: 2e-5}), 4.0))
    assert "wall 4.000 s, device busy 1.700 s a card, idle share 0.575; anchors' drift card 0 +0.0200 ms" in text
    assert "file                   calls     1     4.000     2.000" in text
    assert "flush                  calls     1     1.500     1.500" in text
    assert "swt_k1                                   2     1.500" in text
    assert "traceback:windowed        0.200" in text
