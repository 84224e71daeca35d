"""Traceback: the share of the window in ``TorchBatchBackend.sites_for_ref``
(``ops.device_traceback``'s full fill, or ``ops.longseq``'s K2, K8 and
windowed fills), in %."""

SPANS = {"traceback": ["sparksmithwaterman_tpu_torch.models.batch_backend:TorchBatchBackend.sites_for_ref"]}
ENTRIES = ()


def read(trace):
    if trace.window_s <= 0:
        return None
    return 100.0 * trace.span_seconds("traceback") / trace.window_s
