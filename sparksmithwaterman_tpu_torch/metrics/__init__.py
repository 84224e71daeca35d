"""Benchmarking and dataset tooling of the port: the counterpart of
:mod:`sparksmithwaterman_tpu.metrics`, with the same exports."""

from sparksmithwaterman_tpu_torch.metrics.running_median import RunningMedian
from sparksmithwaterman_tpu_torch.metrics.refset_info import RefSetInfo, format_info, get_info, print_all_info
from sparksmithwaterman_tpu_torch.metrics.threaded_refset_info import get_info_threaded, print_all_info_threaded
from sparksmithwaterman_tpu_torch.metrics import engineer_data
from sparksmithwaterman_tpu_torch.metrics.execution_times import run_sweeps

__all__ = [
    "RunningMedian",
    "RefSetInfo",
    "format_info",
    "get_info",
    "get_info_threaded",
    "print_all_info",
    "print_all_info_threaded",
    "engineer_data",
    "run_sweeps",
]
