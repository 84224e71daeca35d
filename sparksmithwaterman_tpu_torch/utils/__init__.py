"""Cross-cutting utilities (profiling, counters)."""

from sparksmithwaterman_tpu_torch.utils.profiling import GcupsCounter, profiler_trace

__all__ = ["GcupsCounter", "profiler_trace"]
