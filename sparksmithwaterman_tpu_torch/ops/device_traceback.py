"""On-device traceback: batched fill, max-cell extraction and walks.

Port of :mod:`sparksmithwaterman_tpu.ops.device_traceback`.  Each pair's
fill, its max cells (row-major up to a fixed capacity) and the walk from
each run in one launch on the card (``cuda_score.fill_list``: K9 and K10,
the codes kept on chip, no H); only (cells, beginnings, walk codes) go to
the host, where the strings are assembled.
"""

from __future__ import annotations

from typing import List

import numpy as np

from sparksmithwaterman_tpu_torch.io.report import Site
from sparksmithwaterman_tpu_torch.ops.cuda_score import fill_list
from sparksmithwaterman_tpu_torch.ops.traceback import degenerate_sites


def path_cap(m: int, match: int, gap: int) -> int:
    """Walk steps provably enough for any positive-score path of a
    length-m read.

    Every step consumes a read position (at most m of those) or is a
    deletion; a path with score >= 1 has deletions * |gap| < match * m.
    So steps < m + match*m/|gap|.  The floor of 4m keeps the walk arrays
    the JAX package's shape at the default scheme (5/-3/-4), where the
    bound is 2.25m.
    """
    m = max(m, 1)
    return max(4 * m, m + -(-match * m // -gap) + 1)


def fill_and_trace(
    reads,
    refs,
    match: int,
    mismatch: int,
    gap: int,
    *,
    capacity: int,
    cap: int,
    tie_semantics: str = "serial",
):
    """Fill + max-cell extraction + traceback, all on the tensors' device.

    reads: (B, M) uint8; refs: (B, N) or (1, N) uint8.  Returns
      best:   (B,) int32 max score per pair
      counts: (B,) int32 number of max cells (may exceed capacity; the
              caller lists and walks those pairs again at their counts)
      cells:  (B, capacity, 2) int32 row-major max cells, -1-filled
      begins: (B, capacity) int32 1-based start columns
      codes:  (B, capacity, cap) int8 walk codes (end-to-start)
    """
    return fill_list(reads, refs, match, mismatch, gap, capacity=capacity, cap=cap, tie_semantics=tie_semantics)


def assemble_site(
    codes: np.ndarray,
    begin: int,
    cell,
    ref_seq: str,
    read_seq: str,
    gap_char: str = "_",
) -> Site:
    """Host assembly of one site from walk codes (vectorized numpy)."""
    nz = np.flatnonzero(codes == 0)
    length = int(nz[0]) if nz.size else codes.shape[0]
    if length == 0:
        return (0, ("", ""))
    c = codes[:length].astype(np.int64)
    move_i = (c == 1) | (c == 2)
    move_j = (c == 1) | (c == 3)
    i_end, j_end = int(cell[0]) + 1, int(cell[1]) + 1
    # Position BEFORE each step (the walk emits end-to-start).
    i_pos = i_end - np.concatenate([[0], np.cumsum(move_i)[:-1]])
    j_pos = j_end - np.concatenate([[0], np.cumsum(move_j)[:-1]])
    ref_arr = np.frombuffer(ref_seq.encode("latin-1"), dtype="S1")
    read_arr = np.frombuffer(read_seq.encode("latin-1"), dtype="S1")
    gap_b = gap_char.encode("latin-1")
    ref_chars = np.where(c == 2, gap_b, ref_arr[j_pos - 1])
    read_chars = np.where(c == 3, gap_b, read_arr[i_pos - 1])
    return (
        int(begin),
        (
            ref_chars[::-1].tobytes().decode("latin-1"),
            read_chars[::-1].tobytes().decode("latin-1"),
        ),
    )


def sites_from_trace(
    best: int,
    count: int,
    cells: np.ndarray,
    begins: np.ndarray,
    codes: np.ndarray,
    ref_seq: str,
    read_seq: str,
    gap_char: str = "_",
) -> List[Site]:
    """Per-pair site list from device outputs (oracle-parity order).

    Only cells inside the real (m, n) region count: padded regions can
    tie a zero max but never a positive one.
    """
    m, n = len(read_seq), len(ref_seq)
    if m == 0 or n == 0:
        return []
    if best == 0:
        return degenerate_sites(m, n)
    return [
        assemble_site(codes[t], int(begins[t]), cells[t], ref_seq, read_seq, gap_char)
        for t in range(count)
    ]
