"""Backends and the directory pipeline of the port."""

from sparksmithwaterman_tpu_torch.models.aligner import SerialBackend, get_backend
from sparksmithwaterman_tpu_torch.models.pipeline import run_pipeline

__all__ = ["run_pipeline", "SerialBackend", "get_backend"]
