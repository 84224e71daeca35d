"""Scoring flush on the host: the share of the window in
``TorchBatchBackend._totals_dev`` (encode, pack, K1 launches, the
per-reference sums; ``ShardedBackend`` inherits it), less the time inside
it in which the host is blocked on the card, in %.

The blocked time is what the benchmark can see of it: the throttle that
keeps at most four dispatches in flight (``_mark``, which waits on an
event) and the backend's uploads from pageable memory (``_upload``), which
wait for the kernels queued on the card before they copy.  The uploads'
own copies go with them.  ``ShardedBackend``'s uploads to the other cards
do not pass through ``_upload``; each waits only for its own card's queue,
which the wait for the first card's has mostly drained.
"""

SPANS = {
    "dispatch": ["sparksmithwaterman_tpu_torch.models.batch_backend:TorchBatchBackend._totals_dev"],
    "dispatch_wait": ["sparksmithwaterman_tpu_torch.models.batch_backend:TorchBatchBackend._mark",
                      "sparksmithwaterman_tpu_torch.models.batch_backend:TorchBatchBackend._upload"],
}
ENTRIES = ()


def read(trace):
    if trace.window_s <= 0:
        return None
    flushes = trace.spans_named("dispatch")
    waits = [(a, b) for a, b, _ in trace.spans_named("dispatch_wait")
             if any(fa <= a and b <= fb for fa, fb, _ in flushes)]
    return 100.0 * (sum(b - a for a, b, _ in flushes) - sum(b - a for a, b in waits)) / trace.window_s
