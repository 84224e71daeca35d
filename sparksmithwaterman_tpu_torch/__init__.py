"""Smith-Waterman alignment engine on PyTorch and CUDA (NVIDIA Hopper).

A port of :mod:`sparksmithwaterman_tpu` (JAX/Pallas on TPU), which stays
beside it as the reference.  Module names mirror the JAX package so each
counterpart is easy to find:

- :mod:`.ops.recurrence` — the linear-gap DP in PyTorch (row form);
- :mod:`.ops.cuda_score` — the hand-written Hopper kernels (CUDA C++ in
  ``csrc/``) with their plain PyTorch versions;
- :mod:`.ops.packing`, :mod:`.ops.traceback`, :mod:`.ops.device_traceback`,
  :mod:`.ops.longseq` — read packing and the two traceback branches;
- :mod:`.models.batch_backend` — ``TorchBatchBackend``, the single-device
  ``batch`` strategy;
- :mod:`.models.pipeline` and :mod:`.cli` — the ``swtorch`` entry points
  (``align``, ``info``, ``gen``, ``bench``, ``diff``, ``scaling``);
- :mod:`.parallel` — the mesh strategies, and :mod:`.parallel.multihost`,
  the reference files sharded over processes of a gloo group;
- :mod:`.metrics` — dataset statistics, the sweep corpora, the
  execution-time sweeps, the strategy diff and the scaling sweep;
- :mod:`.dryrun` — one sharded step on an n-entry mesh.

Configuration, parsing, report formatting, directory crawling, the serial
oracle and the synthetic corpora are the port's own copies of the JAX
package's jax-free modules, so the port runs from a checkout without that
package.  This package imports neither ``jax`` nor
``sparksmithwaterman_tpu``.
"""

__version__ = "0.1.0"

from sparksmithwaterman_tpu_torch.config import AlignConfig, ScoringScheme

__all__ = ["AlignConfig", "ScoringScheme", "__version__"]
