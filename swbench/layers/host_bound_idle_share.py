"""Card idle while the host works: per card, the window less the union of
its launches (each from its first timing event to its second, placed on
the host clock by the tracer's anchors) less the time under the
program's ``wait`` spans, averaged over the cards, in %.  Read from the
port's own tracer, which importing this module switches on
(``swbench.program_trace``); nothing where the run launched nothing on a
card, and ``spec.ABSENT`` on a tree without the tracer.

The run's notes (standard error) get the anchors' drift on each card, the
earliest a launch's first event falls before its enqueue, the ten longest
idle gaps (the window less a card's launches), each named by the program
spans whose self time covers it with seconds per span, and the idle
seconds of every gap by span."""

from swbench import program_trace as pt
from swbench import spec

SPANS = {}
ENTRIES = ()
# Gaps the notes name one by one.
NAMED_GAPS = 10

pt.switch_on()


def _named(by: dict) -> str:
    return ", ".join(f"{label} {s:.4f}" for label, s in sorted(by.items(), key=lambda e: -e[1]))


def read(trace):
    rec = pt.records()
    if rec is spec.ABSENT:
        return rec
    if rec is None or trace.window_s <= 0:
        return None
    window = trace.window
    waits = pt.spans(rec, "wait", window)
    shares, gaps = [], []
    for device in range(trace.cards):
        idle = pt.idle(rec, device, window)
        gaps += [(a, b, device) for a, b in idle]
        shares.append(pt.total(pt.minus(idle, waits)))

    inside = [x for x in rec.launches if window[0] <= x.host_t <= window[1]]
    lead = min((x.start - x.host_t for x in inside), default=0.0)
    n_spans = sum(window[0] <= s.start and s.end <= window[1] for s in rec.spans)
    trace.notes.append("host_bound_idle_share: anchors' drift (host less card) "
                       + ", ".join(f"card {d} {s * 1e3:+.4f} ms" for d, s in sorted(rec.drift.items()))
                       + f"; earliest first event against its enqueue {lead * 1e6:+.1f} us; "
                       f"{n_spans} spans and {len(inside)} launches in the window")
    longest = sorted(gaps, key=lambda g: g[0] - g[1])[:NAMED_GAPS]
    for k, ((a, b, device), by) in enumerate(zip(longest, pt.attribute([g[:2] for g in longest], rec)), 1):
        trace.notes.append(f"host_bound_idle_share: gap {k}: {b - a:.4f} s on card {device} from "
                           f"+{a - window[0]:.3f} s: {_named(by)}")
    every: dict = {}
    for by in pt.attribute([g[:2] for g in gaps], rec):
        for label, s in by.items():
            every[label] = every.get(label, 0.0) + s
    trace.notes.append(f"host_bound_idle_share: idle seconds of all {len(gaps)} gaps by span: {_named(every)}")
    return 100.0 * sum(shares) / len(shares) / trace.window_s
