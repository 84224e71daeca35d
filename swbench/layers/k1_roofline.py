"""K1's one-pass form (row lanes <= 1,024): its share of the bound, in %,
over the scoring flushes whose K1 launches are all one-pass
(``swbench.kernels.k1_roofline``)."""

from swbench import kernels

SPANS = {"flush": ["sparksmithwaterman_tpu_torch.models.batch_backend:TorchBatchBackend._dispatch_cols"]}
SPAN_VALUES = {"flush": kernels.flush_value}
ENTRIES = kernels.K1_ENTRIES


def read(trace):
    return kernels.k1_roofline(trace, wide=False)
