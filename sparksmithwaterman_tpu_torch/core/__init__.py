"""The serial NumPy oracle of the port."""

from sparksmithwaterman_tpu_torch.core.oracle import fill_matrices, opt_alignments, traceback_one

__all__ = ["opt_alignments", "fill_matrices", "traceback_one"]
