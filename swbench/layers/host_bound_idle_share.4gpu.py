"""``host_bound_idle_share`` of the four-card cells, which move ``real_gcups.4gpu``."""

from swbench.layers.host_bound_idle_share import ENTRIES, SPANS, read  # noqa: F401
