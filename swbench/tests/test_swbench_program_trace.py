"""The readers of the port's own tracer (``encode_share``,
``host_wait_share``, ``host_bound_idle_share`` and their twins): on the
tiny CPU cell the program records its spans but no launch, so the three
read nothing; on synthetic records each reads what the arithmetic says,
and the idle gaps are named by the program's spans."""

import types

import pytest

from sparksmithwaterman_tpu_torch.utils import profiling
from swbench import program_trace, run, spec

READERS = ("encode_share", "host_wait_share", "host_bound_idle_share")


def test_the_tiny_cpu_cell_records_spans_but_no_launch(tiny):
    result = run.run_cell("tiny.x", 2**31 + 7, 8.0, True, "cpu", root=tiny, log=lambda m: None)
    # No card: these readers, like the kernel readers, are left out.
    assert result["checks"]["mismatches"]["value"] == 0 and result["correct"]
    assert not set(READERS) & set(result["metrics"])
    assert profiling.tracing()
    rec = profiling.records()
    assert rec.launches == []
    names = {s.name for s in rec.spans}
    assert names >= {"file", "parse", "flush", "encode", "wait", "traceback", "report"}, names
    assert program_trace.records() is None


def _span(name, a, b, parent=None, **attrs):
    s = profiling.Span(profiling.TRACER, name, attrs)
    s.start, s.end, s.parent = a, b, parent
    s.file = 0
    return s


def _records():
    f = _span("file", 0.0, 10.0)
    flush = _span("flush", 2.0, 6.0, f, cells=10, refs=2, ref_bp=5)
    tb = _span("traceback", 7.0, 8.0, f, branch="full")
    spans = [
        _span("parse", 0.0, 2.0, f),
        _span("encode", 2.0, 3.0, flush),
        _span("wait", 4.0, 5.0, flush, on="throttle"),
        flush,
        _span("wait", 6.0, 6.5, f, on="resolve"),
        _span("wait", 7.5, 7.8, tb, on="readback"),
        tb,
        _span("report", 9.0, 10.0, f),
        f,
    ]
    launches = []
    for device, start, end in ((0, 3.0, 4.5), (0, 5.0, 7.0), (1, 3.2, 6.0)):
        x = profiling.Launch("swt_lane_best_varlen_s16x2", device, start - 1e-5, flush, ())
        x.start, x.end = start, end
        launches.append(x)
    return profiling.Records(spans, launches, {0: 1e-4, 1: -2e-4})


@pytest.mark.parametrize("suffix", ["", ".4gpu"])
def test_the_readers_on_synthetic_records(monkeypatch, suffix):
    monkeypatch.setattr(program_trace, "records", _records)
    trace = types.SimpleNamespace(window=(0.0, 10.0), window_s=10.0, cards=2, notes=[])
    values = {name: spec.reader(name + suffix).read(trace) for name in READERS}
    # encode 2-3; waits 4-5, 6-6.5, 7.5-7.8; card 0 idle 0-3, 4.5-5, 7-10
    # less waits 0.8 = 5.7 s, card 1 idle 0-3.2, 6-10 less 0.8 = 6.4 s.
    assert values == pytest.approx({"encode_share": 10.0, "host_wait_share": 18.0,
                                    "host_bound_idle_share": 60.5})
    notes = "\n".join(trace.notes)
    assert "card 0 +0.1000 ms" in notes and "card 1 -0.2000 ms" in notes and "+10.0 us" in notes
    assert "gap 1: 4.0000 s on card 1 from +6.000 s: file 1.5000, report 1.0000, traceback:full 0.7000, " \
           "wait:resolve 0.5000, wait:readback 0.3000" in notes
    assert "gap 2: 3.2000 s on card 1 from +0.000 s: parse 2.0000, encode 1.0000, flush 0.2000" in notes
    assert "idle seconds of all 5 gaps by span: " in notes


@pytest.mark.parametrize("suffix", ["", ".4gpu"])
def test_on_a_tree_without_the_tracer_the_readers_say_absent(monkeypatch, suffix):
    """A program with no tracer (a parent older than it) has nothing of
    their kind: the readers say so, not that they read nothing."""
    def missing():
        raise ImportError("no tracer")

    monkeypatch.setattr(program_trace, "_profiling", missing)
    trace = types.SimpleNamespace(window=(0.0, 10.0), window_s=10.0, cards=2, notes=[])
    assert all(spec.reader(name + suffix).read(trace) is spec.ABSENT for name in READERS)


def test_interval_arithmetic():
    assert program_trace.union([(3, 4), (0, 1), (0.5, 2), (2, 2.5), (5, 5)]) == [(0, 2.5), (3, 4)]
    assert program_trace.minus([(0, 10)], [(1, 2), (3, 4), (9, 12)]) == [(0, 1), (2, 3), (4, 9)]
    assert program_trace.minus([(0, 1), (2, 3)], [(0.5, 2.5)]) == [(0, 0.5), (2.5, 3)]
    assert program_trace.clip([(-1, 1), (2, 3), (9, 11), (12, 13)], (0, 10)) == [(0, 1), (2, 3), (9, 10)]
    assert program_trace.total([(0, 1), (2, 3.5)]) == 2.5
