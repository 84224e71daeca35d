"""Reference encoding and split on the host: the share of the window in
the program's ``encode`` spans, in %.  ``TorchBatchBackend`` opens one a
flush around ``encode_concat``, the argsort and the offsets;
``ShardedBackend`` one around ``mesh.split_by_bp`` and one around each
card's encode.  Read from the port's own tracer
(``utils.profiling``), which importing this module switches on
(``swbench.program_trace``); nothing where the run launched nothing on a
card, and ``spec.ABSENT`` on a tree without the tracer."""

from swbench import program_trace, spec

SPANS = {}
ENTRIES = ()

program_trace.switch_on()


def read(trace):
    rec = program_trace.records()
    if rec is spec.ABSENT:
        return rec
    if rec is None or trace.window_s <= 0:
        return None
    return 100.0 * program_trace.total(program_trace.spans(rec, "encode", trace.window)) / trace.window_s
