"""Strategy -> backend resolution for the port.

Port of ``sparksmithwaterman_tpu.models.aligner``: ``serial`` is the
NumPy oracle backend, ``batch`` and ``wavefront`` the torch backend on
one device, ``shard_refs`` / ``shard_reads`` and
``shard_seq`` the mesh backends of :mod:`..parallel` over every card of
the host (or the one device named).
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np

from sparksmithwaterman_tpu_torch.config import AlignConfig, ScoringScheme
from sparksmithwaterman_tpu_torch.core import oracle
from sparksmithwaterman_tpu_torch.io.report import Site

class SerialBackend:
    """Pure-NumPy serial engine, the parity oracle of the pipeline."""

    def __init__(self, scoring: ScoringScheme = ScoringScheme()):
        self.scoring = scoring

    def totals(self, reads: Sequence[str], ref_seqs: Sequence[str]) -> np.ndarray:
        out = np.zeros(len(ref_seqs), dtype=np.int64)
        for k, ref in enumerate(ref_seqs):
            out[k] = sum(oracle.opt_alignments(ref, read, self.scoring)[0] for read in reads)
        return out

    def sites_for_ref(self, ref_seq: str, reads: Sequence[str]) -> List[Site]:
        sites: List[Site] = []
        for read in reads:
            _, read_sites = oracle.opt_alignments(
                ref_seq, read, self.scoring, tie_semantics=self.scoring.tie_semantics
            )
            sites.extend(read_sites)
        sites.sort(key=lambda s: s[0])  # stable: ties keep read order
        return sites

    def best_of(self, reads: Sequence[str], ref_seqs: Sequence[str]) -> Tuple[int, List[int]]:
        """(best_total, tie indices in encounter order) of one flush."""
        totals = self.totals(reads, ref_seqs)
        if len(totals) == 0:
            return 0, []
        best = int(totals.max())
        return best, [int(i) for i in np.flatnonzero(totals == best)]


def get_backend(config: AlignConfig, device="cuda"):
    """Resolve ``config.strategy`` to a backend on ``device``.

    ``wavefront`` (the reference's DistributeAlgorithm) is ``batch`` with
    the anti-diagonal kernel pinned: ``kernel='diag'`` whatever the config
    says, as in the JAX package; ``batch`` keeps the config's kernel.  The
    mesh strategies take every card for ``device="cuda"`` and the one
    device otherwise (``parallel.mesh.mesh_devices``).
    """
    if config.strategy == "serial":
        return SerialBackend(config.scoring)
    if config.strategy in ("batch", "wavefront"):
        from sparksmithwaterman_tpu_torch.models.batch_backend import TorchBatchBackend

        if config.strategy == "wavefront":
            config = dataclasses.replace(config, kernel="diag")
        return TorchBatchBackend(config, device)
    if config.strategy in ("shard_refs", "shard_reads"):
        from sparksmithwaterman_tpu_torch.parallel.engine import ShardedBackend

        return ShardedBackend(config, device=device)
    if config.strategy == "shard_seq":
        from sparksmithwaterman_tpu_torch.parallel.seqparallel import SeqParallelBackend

        return SeqParallelBackend(config, device=device)
    raise ValueError(f"Unknown strategy: {config.strategy!r}")
