"""Typed configuration of the port.

The scoring scheme and the pipeline settings of
:mod:`sparksmithwaterman_tpu.config`, kept here so the port runs from a
checkout that holds no JAX package.  Of the TPU build's engine knobs the
port keeps the two that choose a scoring path (``kernel``,
``pack_reads``); ``use_pallas`` (Pallas or lax) and ``read_block`` (a
TPU grid block) have no counterpart: every path runs its own kernel.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class ScoringScheme:
    """Smith-Waterman scoring parameters with a linear gap penalty.

    The fields keep the JAX package's order, so a positional construction
    means the same in both packages.  ``types`` are the characters of the
    direction codes (alignment, insertion, deletion, none), as
    :func:`..core.oracle.align_chars` renders them.  ``tie_semantics``
    picks which of the reference's two cell engines the traceback mirrors
    on tied paths (scores are identical either way): ``"serial"``
    (``>=``, ties a > i > d) or ``"distributed"`` (strict ``>``, ties
    d > i > a).
    """

    match: int = 5
    mismatch: int = -3
    gap: int = -4
    types: Tuple[str, str, str, str] = ("a", "i", "d", "-")
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

    @property
    def align_scores(self) -> Tuple[int, int, int]:
        return (self.match, self.mismatch, self.gap)


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
    # serial | batch | wavefront (batch with kernel='diag') | shard_refs | shard_reads | shard_seq
    strategy: str = "batch"
    read_bucket: int = 128  # reads pad to multiples of this (traceback, unpacked scoring)
    ref_bucket: int = 256  # references pad to multiples of this (or its 1.5 x 2^k ladder)
    # Scoring kernel of batch and shard_refs/shard_reads: 'diag' (the
    # anti-diagonal wavefront: K1 packed, K4 unpacked) or 'row' (the row
    # form, K5, on unpacked reads whatever pack_reads says).
    kernel: str = "diag"
    # Bin-pack several reads per kernel row (ops/packing, K1); False
    # scores unpacked reads bucketed by length (K4).
    pack_reads: bool = True
    # Read rows per round of parallel.seqparallel_scores[_batch] (the striped
    # ring) only; the shard_seq backend scores through K3 and does not read it.
    seq_stripe: int = 8
    # Reference base pairs accumulated across files per scoring flush.
    ref_batch_bp: int = 32_000_000

    def __post_init__(self):
        if self.kernel not in ("diag", "row"):
            raise ValueError(f"kernel must be 'diag' or 'row', got {self.kernel!r}")
