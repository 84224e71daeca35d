"""Device: the event-timed ms of every launch of the kernel library over
the window, averaged over the cards, in %.  Copies and PyTorch's own
kernels are left out, so this is not one minus the idle share."""

SPANS = {}
ENTRIES = "*"


def read(trace):
    launches = trace.launches_of()
    if trace.window_s <= 0 or not launches:
        return None
    return 100.0 * sum(x.ms for x in launches) / 1e3 / (trace.window_s * trace.cards)
