"""Host traceback from a full fill (the fallback of the device walk).

Port of :mod:`sparksmithwaterman_tpu.ops.traceback`: all optimal sites of
one pair from its (M, N) score and direction matrices, as the reference's
``GetAlignment`` (``src/sw/SmithWaterman.java:354-436``), walked by the
native tracer (``csrc/traceback.c``).
"""

from __future__ import annotations

from typing import List

import numpy as np

from sparksmithwaterman_tpu_torch.io.report import Site, truncation_note
from sparksmithwaterman_tpu_torch._native import traceback_batch

# Degenerate all-zero matrices make every cell a "max cell"
# (``SmithWaterman.java:176-185``).  Past this many identical empty sites
# the list is cut and ends with a truncation note (the JAX package's
# documented deviation, reproduced for byte parity).
DEGENERATE_SITE_CAP = 1 << 20


def degenerate_sites(m: int, n: int) -> List[Site]:
    """The all-zero-matrix site list: m*n empty sites, capped."""
    total = m * n
    if total <= DEGENERATE_SITE_CAP:
        return [(0, ("", ""))] * total
    return [(0, ("", ""))] * DEGENERATE_SITE_CAP + [
        truncation_note(total - DEGENERATE_SITE_CAP)
    ]


def sites_from_fill(
    h: np.ndarray,
    dirs: np.ndarray,
    ref_seq: str,
    read_seq: str,
    gap_char: str = "_",
) -> List[Site]:
    """All optimal sites for one pair from its padded (M, N) fill (rows
    1..M); only the real (len(read), len(ref)) region is consulted."""
    m, n = len(read_seq), len(ref_seq)
    if m == 0 or n == 0:
        return []
    hr = np.asarray(h[:m, :n])
    max_score = int(hr.max())
    if max_score == 0:
        return degenerate_sites(m, n)
    cells = np.argwhere(hr == max_score)  # row-major discovery order
    return traceback_batch(np.asarray(dirs[:m, :n]), cells, ref_seq, read_seq, gap_char)
