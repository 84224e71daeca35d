"""``k1_roofline`` of the four-card cells, which move ``real_gcups.4gpu``."""

from swbench.layers.k1_roofline import ENTRIES, SPAN_VALUES, SPANS, read  # noqa: F401
