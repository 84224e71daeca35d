"""Single-device batched backend on PyTorch: the ``batch`` strategy.

Port of :class:`sparksmithwaterman_tpu.models.batch_backend.BatchBackend`
(its packed varlen path and both traceback branches):

- scoring bin-packs the reads into lane rows (``ops.packing``) and makes
  one K1 dispatch (``ops.cuda_score.lane_best_packed_varlen``) per
  reference chunk; start lanes are gathered and summed per reference in
  int64 on the device, and the best total and its tie mask are reduced
  there too, so one small copy reaches the host per flush;
- :meth:`TorchBatchBackend.sites_for_ref` traces a winner either with a
  full fill with directions and an on-device walk, or — for large read
  sets and long references — with one argmax pass (K2) and window fills.

The TPU package's VMEM planners, interleaved lanes, window tables,
reference folding, compile-shape padding and 32-bit carry-pair reduce
have no counterpart here: a CUDA block reads ``ref[d - i]`` from shared
memory and torch has int64 on the device.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from sparksmithwaterman_tpu_torch.config import AlignConfig
from sparksmithwaterman_tpu_torch.io.fasta import READ_PAD, REF_PAD, encode_batch, encode_concat
from sparksmithwaterman_tpu_torch.io.report import Site
from sparksmithwaterman_tpu_torch.utils.profiling import GcupsCounter
from sparksmithwaterman_tpu_torch.ops.cuda_score import lane_best_packed_varlen
from sparksmithwaterman_tpu_torch.ops.device_traceback import (
    fill_and_trace,
    path_cap,
    sites_from_trace,
)
from sparksmithwaterman_tpu_torch.ops.longseq import (
    find_max_cells_batched,
    sites_for_ref_long_batched,
)
from sparksmithwaterman_tpu_torch.ops.packing import pack_reads, packed_col_sums
from sparksmithwaterman_tpu_torch.ops.recurrence import fill_pairs
from sparksmithwaterman_tpu_torch.ops.traceback import sites_from_fill

# Max cells per pair walked on the device; a pair with more falls back
# to a full fill and the host walk.
_TRACE_CAPACITY = 64
# Element budget of the (B, M, N) fill of one traceback dispatch.
_FILL_BUDGET = 1 << 26
# Read sets this large take the windowed traceback whatever the ref length.
_WINDOW_READS = 1024
# Reads per pack chunk are capped so that r * match * m stays below this:
# per-read scores and each pack's sums stay far inside int32.
_INT32_SAFE = (1 << 31) - (1 << 24)
# Element budget of one K1 dispatch's (C, ROWS, M) int32 output.
_OUT_BUDGET = 1 << 28
# Dispatches the host may run ahead of the device.
_MAX_IN_FLIGHT = 4


def _pad_len(n: int, bucket: int) -> int:
    return max(bucket, -(-n // bucket) * bucket)


def _group_by_padded_len(seqs: Sequence[str], bucket: int) -> Dict[int, List[int]]:
    groups: Dict[int, List[int]] = {}
    for idx, s in enumerate(seqs):
        groups.setdefault(_pad_len(len(s), bucket), []).append(idx)
    return groups


class TorchBatchBackend:
    """The ``batch`` strategy on one torch device (CUDA, or CPU with the
    kernels' plain versions)."""

    def __init__(self, config: AlignConfig, device="cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"device {self.device} requested but CUDA is not available")
        self.scoring = config.scoring
        self.read_bucket = config.read_bucket
        self.ref_bucket = config.ref_bucket
        self._params = (self.scoring.match, self.scoring.mismatch, self.scoring.gap)
        # DP cells over the dispatch window (real cells = sum |read|*|ref|).
        self.gcups = GcupsCounter()
        # Packs of the last reads list (identity, length and total bp
        # checked): the pipeline scores one reads list against every
        # flush of an input file.
        self._pack_cache: Tuple[object, int, int, int, List[dict]] = (None, -1, -1, 0, [])

    def _upload(self, arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)

    def _mark(self, events: list) -> None:
        """Record the end of a dispatch; keep at most _MAX_IN_FLIGHT
        dispatches ahead of the device."""
        if self.device.type != "cuda":
            return
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(self.device))
        events.append(event)
        if len(events) >= _MAX_IN_FLIGHT:
            events[-_MAX_IN_FLIGHT].synchronize()

    # -- scoring ------------------------------------------------------------

    def totals(self, reads: Sequence[str], ref_seqs: Sequence[str]) -> np.ndarray:
        """Per-reference total score over all reads (int64)."""
        if not reads or not ref_seqs:
            return np.zeros(len(ref_seqs), dtype=np.int64)
        with self.gcups.measure_lazy() as done:
            totals, cells = self._totals_dev(reads, ref_seqs)
            out = totals.cpu().numpy()
            done(cells)
        return out

    def best_of(self, reads: Sequence[str], ref_seqs: Sequence[str]) -> Tuple[int, List[int]]:
        """(best_total, tie_indices): the winner reduce of one flush; tie
        indices ascend, which is encounter order."""
        return self.best_of_async(reads, ref_seqs)()

    def best_of_async(self, reads, ref_seqs):
        """Dispatch ``best_of`` and return ``resolve() -> (best, ties)``.

        The reduce runs on the device; its (C + 1) int64 result is copied
        into pinned host memory without blocking, and ``resolve`` waits on
        an event recorded after the copy, so the pipeline can dispatch the
        next flush first.
        """
        c = len(ref_seqs)
        if not reads or not ref_seqs:
            return lambda: (0, list(range(c)))
        cuda = self.device.type == "cuda"
        with self.gcups.measure_lazy() as done:
            totals, cells = self._totals_dev(reads, ref_seqs)
            best = totals.max()
            combined = torch.cat([(totals == best).to(torch.int64), best.view(1)])
            host = torch.empty(c + 1, dtype=torch.int64, pin_memory=cuda)
            host.copy_(combined, non_blocking=cuda)
            event = None
            if cuda:
                event = torch.cuda.Event()
                event.record(torch.cuda.current_stream(self.device))
            done(cells)

        def resolve() -> Tuple[int, List[int]]:
            if event is not None:
                event.synchronize()
            arr = host.numpy()
            return int(arr[c]), [int(i) for i in np.flatnonzero(arr[:c])]

        return resolve

    def _totals_dev(self, reads, ref_seqs) -> Tuple[torch.Tensor, int]:
        pending, cells = self._dispatch_cols(reads, ref_seqs)
        totals = torch.zeros(len(ref_seqs), dtype=torch.int64, device=self.device)
        for chunk, col in pending:
            totals.index_add_(0, chunk, col.to(self.device, non_blocking=True))
        return totals, cells

    def _dispatch_cols(self, reads, ref_seqs):
        """One K1 dispatch per (pack x reference chunk), not waited on.

        The flush's references are encoded back to back into one buffer
        and uploaded once; each dispatch reads its references there by
        offset.  References go longest first, so the longest blocks start
        first; a chunk is capped by the K1 output budget.  Returns
        ([(device ref indices, (C,) int64 device sums)], real cells).
        """
        r_limit = max(1, _INT32_SAFE // max(1, self.scoring.match))
        packs = self._pack_chunks(reads, r_limit)
        flat, lens = encode_concat(list(ref_seqs))
        offsets = np.zeros_like(lens)
        np.cumsum(lens[:-1], out=offsets[1:])
        order = np.argsort(-lens, kind="stable")
        flat_t = self._upload(flat)
        order_t = self._upload(order)
        lens_t = self._upload(lens[order].astype(np.int32))
        offsets_t = self._upload(offsets[order])
        pending: List[Tuple[torch.Tensor, torch.Tensor]] = []
        events: list = []
        cells = 0
        for pack in packs:
            c_block = max(1, _OUT_BUDGET // max(1, pack["rows"] * pack["m_pack"]))
            for start in range(0, len(order), c_block):
                part = slice(start, start + c_block)
                lane = lane_best_packed_varlen(
                    pack["packed"], flat_t, lens_t[part], *self._params, offsets=offsets_t[part]
                )
                pending.append((order_t[part], packed_col_sums(lane, pack["start_idx"])))
                self._mark(events)
            cells += pack["read_bp"] * int(lens.sum())
        return pending, cells

    def _pack_chunks(self, reads: Sequence[str], r_limit: int) -> List[dict]:
        """Bin the reads into packed rows at one lane width (the longest
        read's power-of-two tier, at least 2 * read_bucket and 128), in
        chunks whose total bp respects ``r_limit``; uploaded once and
        cached for the same reads list."""
        total_bp = sum(len(r) for r in reads)
        obj, n, bp, limit, packs = self._pack_cache
        if obj is reads and n == len(reads) and bp == total_bp and limit == r_limit:
            return packs
        m_pack = max(2 * self.read_bucket, 128)
        longest = max(len(r) for r in reads)
        while m_pack < longest:
            m_pack *= 2
        budget = max(m_pack, r_limit)
        packs = []
        chunk: List[int] = []
        chunk_bp = 0
        for i, read in enumerate(reads):
            size = max(1, len(read))
            if chunk and chunk_bp + size > budget:
                packs.append(self._pack(reads, chunk, m_pack))
                chunk, chunk_bp = [], 0
            chunk.append(i)
            chunk_bp += size
        packs.append(self._pack(reads, chunk, m_pack))
        self._pack_cache = (reads, len(reads), total_bp, r_limit, packs)
        return packs

    def _pack(self, reads, idx: List[int], m_pack: int) -> dict:
        packed, start_idx = pack_reads([reads[i] for i in idx], m_pack)
        return dict(
            m_pack=m_pack,
            rows=packed.shape[0],
            packed=self._upload(packed),
            start_idx=self._upload(start_idx.astype(np.int64)),
            read_idx=list(idx),
            read_bp=sum(len(reads[i]) for i in idx),
        )

    # -- traceback ------------------------------------------------------------

    def _windowed(self, ref_seq: str, reads: Sequence[str]) -> bool:
        """The windowed branch: large read sets, or refs past the fill
        budget (fewer than 8 pairs per full-matrix fill)."""
        max_m = max((len(r) for r in reads), default=0)
        n_pad = _pad_len(len(ref_seq), self.ref_bucket)
        return bool(max_m) and (
            8 * n_pad * _pad_len(max_m, self.read_bucket) > _FILL_BUDGET
            or len(reads) >= _WINDOW_READS
        )

    def sites_for_ref(self, ref_seq: str, reads: Sequence[str]) -> List[Site]:
        """All optimal sites of every read against one reference, merged
        in read order and stably sorted by beginning index."""
        if not reads:
            return []
        gap_char = self.scoring.gap_char
        tie = self.scoring.tie_semantics
        if self._windowed(ref_seq, reads):
            cell_lists = find_max_cells_batched(list(reads), ref_seq, self._params, device=self.device)
            per_read = sites_for_ref_long_batched(
                ref_seq, list(reads), self._params,
                gap_char=gap_char, ref_bucket=self.ref_bucket,
                cell_lists=cell_lists, tie_semantics=tie, device=self.device,
            )
        else:
            per_read = self._sites_full_fill(ref_seq, reads)
        merged: List[Site] = []
        for sites in per_read:  # read order (Distribution.java:589-597)
            merged.extend(sites)
        merged.sort(key=lambda s: s[0])  # stable MatchSiteComp sort
        return merged

    def _sites_full_fill(self, ref_seq: str, reads: Sequence[str]) -> List[List[Site]]:
        """Normal branch: per read-length group, fill with directions and
        walk up to _TRACE_CAPACITY max cells per pair on the device."""
        per_read: List[List[Site]] = [[] for _ in reads]
        gap_char = self.scoring.gap_char
        tie = self.scoring.tie_semantics
        n_pad = _pad_len(len(ref_seq), self.ref_bucket)
        ref_t = self._upload(encode_batch([ref_seq], n_pad, REF_PAD))  # (1, N)
        dispatched = []
        for m_pad, read_idx in sorted(_group_by_padded_len(reads, self.read_bucket).items()):
            cap = path_cap(m_pad, self.scoring.match, self.scoring.gap)
            b_block = max(1, _FILL_BUDGET // (m_pad * n_pad))
            for start in range(0, len(read_idx), b_block):
                chunk = read_idx[start : start + b_block]
                reads_enc = encode_batch([reads[i] for i in chunk], m_pad, READ_PAD)
                outs = fill_and_trace(
                    self._upload(reads_enc), ref_t, *self._params,
                    capacity=_TRACE_CAPACITY, cap=cap, tie_semantics=tie,
                )
                dispatched.append((chunk, reads_enc, outs))
        for chunk, reads_enc, outs in dispatched:
            best, counts, cells, begins, codes = (t.cpu().numpy() for t in outs)
            overflow = [k for k in range(len(chunk)) if best[k] > 0 and counts[k] > _TRACE_CAPACITY]
            for k, ridx in enumerate(chunk):
                if k in overflow:
                    continue
                per_read[ridx] = sites_from_trace(
                    int(best[k]), int(counts[k]), cells[k], begins[k], codes[k],
                    ref_seq, reads[ridx], gap_char,
                )
            if overflow:
                h, dirs = fill_pairs(
                    self._upload(reads_enc[overflow]), ref_t, *self._params, tie_semantics=tie
                )
                h, dirs = h.cpu().numpy(), dirs.cpu().numpy()
                for t, k in enumerate(overflow):
                    ridx = chunk[k]
                    per_read[ridx] = sites_from_fill(h[t], dirs[t], ref_seq, reads[ridx], gap_char)
        return per_read
