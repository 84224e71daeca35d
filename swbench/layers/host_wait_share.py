"""Host blocked on the card: the share of the window in the program's
``wait`` spans, in %, time under two nested waits counted once.  The
program opens one around each wait: the in-flight throttle
(``on="throttle"``), every upload from pageable memory and every copy
between cards (``"upload"``), the wait for a flush's best
(``"resolve"``) and each copy of a traceback result to the host
(``"readback"``).  Read from the port's own tracer, which importing this
module switches on (``swbench.program_trace``); nothing where the run
launched nothing on a card, and ``spec.ABSENT`` on a tree without the
tracer."""

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
    return 100.0 * program_trace.total(program_trace.spans(rec, "wait", trace.window)) / trace.window_s
