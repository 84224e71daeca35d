"""Typed configuration of the port.

The scoring scheme and the pipeline settings of
:mod:`sparksmithwaterman_tpu.config`, kept here so the port runs from a
checkout that holds no JAX package.  The engine knobs of the TPU build
(Pallas, kernel form, VMEM modes) have no counterpart: the port has one
scoring kernel per path.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ScoringScheme:
    """Smith-Waterman scoring parameters with a linear gap penalty.

    ``tie_semantics`` picks which of the reference's two cell engines the
    traceback mirrors on tied paths (scores are identical either way):
    ``"serial"`` (``>=``, ties a > i > d) or ``"distributed"`` (strict
    ``>``, ties d > i > a).
    """

    match: int = 5
    mismatch: int = -3
    gap: int = -4
    gap_char: str = "_"
    tie_semantics: str = "serial"

    def __post_init__(self):
        if self.match <= 0:
            raise ValueError("match score must be positive")
        if self.gap >= 0 or self.mismatch >= 0:
            raise ValueError("gap and mismatch scores must be negative")
        if self.tie_semantics not in ("serial", "distributed"):
            raise ValueError(
                f"tie_semantics must be 'serial' or 'distributed', "
                f"got {self.tie_semantics!r}"
            )


@dataclasses.dataclass(frozen=True)
class AlignConfig:
    """End-to-end pipeline configuration."""

    ref_dir: str
    in_dir: str
    out_dir: str
    out_name: str = "result"
    out_ext: str = ".txt"
    delimiter: str = ">gi"
    scoring: ScoringScheme = dataclasses.field(default_factory=ScoringScheme)
    # serial | batch | wavefront (alias of batch) | shard_refs | shard_reads | shard_seq
    strategy: str = "batch"
    read_bucket: int = 128  # traceback fills pad reads to multiples of this
    ref_bucket: int = 256  # ... and references to multiples of this
    # Read rows per round of parallel.seqparallel_scores[_batch] (the striped
    # ring) only; the shard_seq backend scores through K3 and does not read it.
    seq_stripe: int = 8
    # Reference base pairs accumulated across files per scoring flush.
    ref_batch_bp: int = 32_000_000
