"""Device operations of the port: DP recurrence, packing, kernels, traceback.

Re-exports the plain recurrence and the host traceback only; the kernel
modules (``ops.cuda_score``, ``ops._cuda``) are imported explicitly by
their users, so importing this package loads nothing of them (no kernel
build, no CUDA initialisation).
"""

from sparksmithwaterman_tpu_torch.ops.recurrence import fill_pairs, score_grid, score_pairs
from sparksmithwaterman_tpu_torch.ops.traceback import sites_from_fill

__all__ = ["score_pairs", "score_grid", "fill_pairs", "sites_from_fill"]
