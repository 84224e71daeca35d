"""Single-device batched backend on PyTorch: the ``batch`` strategy.

Port of :class:`sparksmithwaterman_tpu.models.batch_backend.BatchBackend`
(its scoring paths and both traceback branches):

- the packed path (``kernel='diag'``, ``pack_reads=True``, the default)
  bin-packs the reads into lane rows (``ops.packing``), a pack for each
  form K1 takes, and makes one K1 dispatch
  (``ops.cuda_score.lane_best_packed_varlen``) per pack and reference
  chunk; start lanes are gathered and summed per reference in int64 on
  the device, and the best total and its tie mask are reduced there too,
  so one small copy reaches the host per flush;
- the unpacked path (``pack_reads=False``, or ``kernel='row'``) buckets
  reads by padded length and references on the 1.5 x 2^k ladder, as the
  JAX package does, and scores each bucket pair's (R, C) grid with K4
  (``score_grid_diag``) or K5 (``score_grid_row``), summed per reference
  in int64 on the device;
- :meth:`TorchBatchBackend.sites_for_ref` traces a winner either with a
  full fill with directions and an on-device walk, or — for large read
  sets and long references — with one argmax pass (K2) and window fills.

The TPU package's VMEM planners, interleaved lanes, window tables,
reference folding, compile-shape padding, read blocks, int32 read-count
caps and 32-bit carry-pair reduce have no counterpart here: a CUDA block
reads ``ref[d - i]`` from shared memory and torch has int64 on the
device.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from sparksmithwaterman_tpu_torch.config import AlignConfig
from sparksmithwaterman_tpu_torch.io.fasta import READ_PAD, REF_PAD, encode_batch, encode_concat
from sparksmithwaterman_tpu_torch.io.report import Site
from sparksmithwaterman_tpu_torch.ops import cuda_score
from sparksmithwaterman_tpu_torch.ops.cuda_score import (
    carry_elems, lane_best_packed_varlen, score_grid_diag, score_grid_row,
)
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
from sparksmithwaterman_tpu_torch.utils.profiling import span

# Max cells per pair listed by the first fill and walk; a pair with more is
# filled, listed at its own count and walked again, still on the device.
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


def _quantize_15(n: int, base: int) -> int:
    """Round up to base * {2^k or 1.5 * 2^k} (1.5 only when a multiple
    of base, i.e. from 3*base upward): at most 1.33x padding with
    O(log n) distinct values (JAX ``batch_backend._quantize_15``)."""
    q = base
    while q < n:
        q15 = q + q // 2
        if n <= q15 and q15 % base == 0:
            return q15
        q *= 2
    return q


def _group_by_padded_len(seqs: Sequence[str], bucket: int, geometric: bool = False) -> Dict[int, List[int]]:
    """Sequence indices by padded length: multiples of ``bucket``, or with
    ``geometric=True`` the :func:`_quantize_15` ladder (fewer groups)."""
    groups: Dict[int, List[int]] = {}
    for idx, s in enumerate(seqs):
        key = _quantize_15(len(s), bucket) if geometric else _pad_len(len(s), bucket)
        groups.setdefault(key, []).append(idx)
    return groups


def ref_chunks(out_per_ref: int, carry_per_ref: Sequence[int], out_budget: int,
               carry_budget: Optional[int] = None) -> List[slice]:
    """Consecutive slices of the references in dispatch order, one
    dispatch each: at most ``out_budget // out_per_ref`` references, and
    carry scratch (``carry_per_ref``, int32 elements per reference) of at
    most ``carry_budget`` (default ``cuda_score.CARRY_BUDGET``) in all; at
    least one reference.  References go longest first, so a chunk's first
    (longest) reference sets how many fit.  With no scratch (rows of at
    most ONE_PASS_LANES lanes) every chunk but the last holds exactly
    ``out_budget // out_per_ref``.  A chunk of one reference over the
    carry budget is split further by rows in the kernel's wrapper
    (``cuda_score.carry_rows``)."""
    cap = max(1, out_budget // max(1, out_per_ref))
    carry_budget = cuda_score.CARRY_BUDGET if carry_budget is None else carry_budget
    carry = np.concatenate(([0], np.cumsum(np.asarray(carry_per_ref, np.int64))))
    chunks, lo, n = [], 0, len(carry) - 1
    while lo < n:
        fit = int(np.searchsorted(carry, carry[lo] + carry_budget, side="right")) - 1
        hi = max(lo + 1, min(n, lo + cap, fit))
        chunks.append(slice(lo, hi))
        lo = hi
    return chunks


def _score_grid(reads_t: torch.Tensor, refs_t: torch.Tensor, params, kernel: str) -> torch.Tensor:
    """(R, C) int32 best per pair on the tensors' device: K4 for
    ``kernel='diag'``, K5 for ``'row'``."""
    fn = score_grid_diag if kernel == "diag" else score_grid_row
    return fn(reads_t, refs_t, *params)


def _col_sums(blocks: list, params, kernel: str) -> list:
    """[(ref columns, (c,) int64 sums over the block's reads)] of staged
    grid blocks [(read rows, ref columns, reads, refs)]: one K4 or K5
    launch per block, on its device (JAX ``_col_sums_dev``)."""
    return [
        (cols, _score_grid(reads_t, refs_t, params, kernel).sum(dim=0, dtype=torch.int64))
        for _, cols, reads_t, refs_t in blocks
    ]


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
        self.kernel = config.kernel
        # kernel='row' ignores pack_reads, as in the JAX package.
        self.pack = config.pack_reads and config.kernel == "diag"
        self._params = (self.scoring.match, self.scoring.mismatch, self.scoring.gap)
        # Packs of the last reads list (identity, length and total bp
        # checked): the pipeline scores one reads list against every
        # flush of an input file.
        self._pack_cache: Tuple[object, int, int, int, List[dict]] = (None, -1, -1, 0, [])

    def _upload(self, arr: np.ndarray) -> torch.Tensor:
        with span("wait", on="upload"):
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
            with span("wait", on="throttle"):
                events[-_MAX_IN_FLIGHT].synchronize()

    # -- scoring ------------------------------------------------------------

    def totals(self, reads: Sequence[str], ref_seqs: Sequence[str]) -> np.ndarray:
        """Per-reference total score over all reads (int64)."""
        if not reads or not ref_seqs:
            return np.zeros(len(ref_seqs), dtype=np.int64)
        return self._flush(reads, ref_seqs).cpu().numpy()

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
        totals = self._flush(reads, ref_seqs)
        best = totals.max()
        combined = torch.cat([(totals == best).to(torch.int64), best.view(1)])
        host = torch.empty(c + 1, dtype=torch.int64, pin_memory=cuda)
        host.copy_(combined, non_blocking=cuda)
        event = None
        if cuda:
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(self.device))

        def resolve() -> Tuple[int, List[int]]:
            if event is not None:
                event.synchronize()
            arr = host.numpy()
            return int(arr[c]), [int(i) for i in np.flatnonzero(arr[:c])]

        return resolve

    def _flush(self, reads, ref_seqs) -> torch.Tensor:
        """One scoring flush (:meth:`_totals_dev`), traced as span ``flush``
        with its real cells, and those K1 scores in its 16-bit form
        (``cells_s16x2``): (C,) int64 totals on the device, not waited on."""
        with span("flush", refs=len(ref_seqs)) as flush:
            totals, cells = self._totals_dev(reads, ref_seqs)
            if flush:
                ref_bp = sum(map(len, ref_seqs))
                flush.set(cells=cells, cells_s16x2=self._s16x2_read_bp(reads) * ref_bp, ref_bp=ref_bp)
        return totals

    def _totals_dev(self, reads, ref_seqs) -> Tuple[torch.Tensor, int]:
        pending, cells = self._dispatch_cols(reads, ref_seqs)
        totals = torch.zeros(len(ref_seqs), dtype=torch.int64, device=self.device)
        for chunk, col in pending:
            totals.index_add_(0, chunk, col.to(self.device, non_blocking=True))
        return totals, cells

    def _dispatch_cols(self, reads, ref_seqs):
        """Dispatch the scoring of one flush, not waited on: the packed
        path (:meth:`_dispatch_packed`) or the unpacked one
        (:meth:`_dispatch_unpacked`).  Returns ([(device ref indices, (C,)
        int64 device sums)], real cells)."""
        if self.pack:
            return self._dispatch_packed(reads, ref_seqs)
        return self._dispatch_unpacked(reads, ref_seqs)

    def _dispatch_packed(self, reads, ref_seqs):
        """One K1 dispatch per (pack x reference chunk), not waited on.

        The flush's references are encoded back to back into one buffer
        and uploaded once; each dispatch reads its references there by
        offset.  References go longest first, so the longest blocks start
        first; a chunk is capped by the K1 output and carry budgets
        (:func:`ref_chunks`).  Returns
        ([(device ref indices, (C,) int64 device sums)], real cells).
        """
        r_limit = max(1, _INT32_SAFE // max(1, self.scoring.match))
        packs = self._pack_chunks(reads, r_limit)
        with span("encode"):
            flat, lens = encode_concat(list(ref_seqs))
            offsets = np.zeros_like(lens)
            np.cumsum(lens[:-1], out=offsets[1:])
            order = np.argsort(-lens, kind="stable")
            lens_o = lens[order]
        flat_t = self._upload(flat)
        order_t = self._upload(order)
        lens_t = self._upload(lens_o.astype(np.int32))
        offsets_t = self._upload(offsets[order])
        pending: List[Tuple[torch.Tensor, torch.Tensor]] = []
        events: list = []
        cells = 0
        for pack in packs:
            # The int32 form's carry sizes: an upper bound of the s16x2 form's.
            carry = carry_elems(pack["m_pack"], pack["rows"], 1) * lens_o
            for part in ref_chunks(pack["rows"] * pack["m_pack"], carry, _OUT_BUDGET):
                lane = lane_best_packed_varlen(
                    pack["packed"], flat_t, lens_t[part], *self._params, offsets=offsets_t[part],
                    carry_cols=int(lens_o[part].sum()), longest=pack["longest"],
                )
                pending.append((order_t[part], packed_col_sums(lane, pack["start_idx"])))
                self._mark(events)
            cells += pack["read_bp"] * int(lens.sum())
        return pending, cells

    def _dispatch_unpacked(self, reads, ref_seqs):
        """One K4 (or K5) dispatch per (reference group x read group x
        reference chunk) and mesh block, not waited on (JAX
        ``_dispatch_cols``, unpacked branch).

        Reads group by ``read_bucket`` multiples, references by the
        geometric ladder of ``ref_bucket``; each read group is encoded at
        the length of its longest read, not at its bucket's width, so the
        kernels sweep no lane that every read of the group leaves as
        trailing READ_PAD (exact: a pad code matches nothing and
        ``ScoringScheme`` has mismatch < 0 and gap < 0).  A chunk is capped
        by the (R, C) int32 output budget and the carry budget of reads
        wider than ONE_PASS_LANES (:func:`ref_chunks`).  Every chunk is staged
        (:meth:`_stage`, encoded and uploaded) before the first launch, since
        an upload from pageable host memory waits for the work queued on its
        device.
        """
        read_groups = sorted(_group_by_padded_len(reads, self.read_bucket).items())
        with span("encode"):
            reads_enc = {
                m_pad: encode_batch([reads[i] for i in idx], max(len(reads[i]) for i in idx), READ_PAD)
                for m_pad, idx in read_groups
            }
        staged = []
        cells = 0
        for n_pad, ref_idx in sorted(_group_by_padded_len(ref_seqs, self.ref_bucket, geometric=True).items()):
            with span("encode"):
                refs_enc = encode_batch([ref_seqs[i] for i in ref_idx], n_pad, REF_PAD)
            ref_bp = sum(len(ref_seqs[i]) for i in ref_idx)
            for m_pad, read_idx in read_groups:
                # The int32 form's carry sizes: an upper bound of the s16x2 form's.
                carry = carry_elems(reads_enc[m_pad].shape[1], len(read_idx), n_pad, row_form=self.kernel == "row")
                for part in ref_chunks(len(read_idx), [carry] * len(ref_idx), _OUT_BUDGET):
                    idx_t = self._upload(np.asarray(ref_idx[part], np.int64))
                    staged.append((idx_t, self._stage(reads_enc[m_pad], refs_enc[part])))
                cells += sum(len(reads[i]) for i in read_idx) * ref_bp
        pending: List[Tuple[torch.Tensor, torch.Tensor]] = []
        events: list = []
        for idx_t, blocks in staged:
            for cols, sums in _col_sums(blocks, self._params, self.kernel):
                pending.append((idx_t[cols], sums))
                self._mark(events)
        return pending, cells

    def _stage(self, reads_enc: np.ndarray, refs_enc: np.ndarray) -> list:
        """One (R, C) grid's inputs on the device, as blocks [(read rows,
        ref columns, reads, refs)]; here one block.  The mesh backend
        splits the grid over its entries."""
        return [(slice(None), slice(None), self._upload(reads_enc), self._upload(refs_enc))]

    def _pack_chunks(self, reads: Sequence[str], r_limit: int) -> List[dict]:
        """Bin the reads into packed rows, one K1 form a pack: the reads
        group by the form K1 takes for each read alone
        (:func:`cuda_score.k1k4_form` at the read's own lane tier, the read
        its longest segment), and each group packs at the lane tier of its
        own longest read, in chunks whose total bp respects ``r_limit``.  So
        a read past the 16-bit rule never puts reads inside it into the
        int32 form; reads of one form give the packs of one group.
        Uploaded once and cached for the same reads list."""
        total_bp = sum(len(r) for r in reads)
        obj, n, bp, limit, packs = self._pack_cache
        if obj is reads and n == len(reads) and bp == total_bp and limit == r_limit:
            return packs
        groups: Dict[str, List[int]] = {}
        for i, read in enumerate(reads):
            groups.setdefault(self._read_form(len(read)), []).append(i)
        packs = []
        for idx in groups.values():
            m_pack = self._lane_tier(max(len(reads[i]) for i in idx))
            budget = max(m_pack, r_limit)
            chunk: List[int] = []
            chunk_bp = 0
            for i in idx:
                size = max(1, len(reads[i]))
                if chunk and chunk_bp + size > budget:
                    packs.append(self._pack(reads, chunk, m_pack))
                    chunk, chunk_bp = [], 0
                chunk.append(i)
                chunk_bp += size
            packs.append(self._pack(reads, chunk, m_pack))
        self._pack_cache = (reads, len(reads), total_bp, r_limit, packs)
        return packs

    def _lane_tier(self, longest: int) -> int:
        """Lanes of a packed row for reads of up to ``longest`` bp: the
        smallest power-of-two multiple of max(2 * read_bucket, 128) that
        holds it."""
        m_pack = max(2 * self.read_bucket, 128)
        while m_pack < longest:
            m_pack *= 2
        return m_pack

    def _pack(self, reads, idx: List[int], m_pack: int) -> dict:
        # K1's bound on a segment's lanes (cuda_score.k1k4_form), on the host.
        longest = max(1, max(len(reads[i]) for i in idx))
        form = cuda_score.k1k4_form(m_pack, *self._params, longest=longest)
        # Rows of one pass stay in blocks of eight.  A striped launch sweeps
        # every row it is given, so a wide pack pads only to its form's
        # pairing: two rows a warp in s16x2, none in int32.
        multiple = 8 if m_pack <= cuda_score.ONE_PASS_LANES else 2 if form == "s16x2" else 1
        packed, start_idx = pack_reads([reads[i] for i in idx], m_pack, multiple)
        return dict(
            m_pack=m_pack,
            rows=packed.shape[0],
            packed=self._upload(packed),
            start_idx=self._upload(start_idx.astype(np.int64)),
            read_idx=list(idx),
            read_bp=sum(len(reads[i]) for i in idx),
            longest=longest,
            form=form,
        )

    def _read_form(self, length: int) -> str:
        """The form K1 takes for one read of ``length`` bp alone, at its own
        lane tier (:func:`cuda_score.k1k4_form`): the form of its pack."""
        length = max(1, length)
        return cuda_score.k1k4_form(self._lane_tier(length), *self._params, longest=length)

    def _s16x2_read_bp(self, reads) -> int:
        """Bases of the reads that K1 scores in its 16-bit form (none on
        the unpacked path): a flush's ``cells_s16x2`` over its ref bp."""
        if not self.pack:
            return 0
        return sum(len(r) for r in reads if self._read_form(len(r)) == "s16x2")

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
        windowed = self._windowed(ref_seq, reads)
        with span("traceback", branch="windowed" if windowed else "full"):
            if windowed:
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
        walk up to _TRACE_CAPACITY max cells per pair on the device; the
        pairs with more are filled and walked again at their own counts."""
        per_read: List[List[Site]] = [[] for _ in reads]
        gap_char = self.scoring.gap_char
        tie = self.scoring.tie_semantics
        n_pad = _pad_len(len(ref_seq), self.ref_bucket)
        ref_t = self._upload(encode_batch([ref_seq], n_pad, REF_PAD))  # (1, N)

        def trace(reads_enc, capacity, cap):
            return fill_and_trace(
                self._upload(reads_enc), ref_t, *self._params, capacity=capacity, cap=cap, tie_semantics=tie,
            )

        def collect(idx, outs, skip=()):
            with span("wait", on="readback"):
                best, counts, cells, begins, codes = (t.cpu().numpy() for t in outs)
            for k, ridx in enumerate(idx):
                if k not in skip:
                    per_read[ridx] = sites_from_trace(
                        int(best[k]), int(counts[k]), cells[k], begins[k], codes[k],
                        ref_seq, reads[ridx], gap_char,
                    )

        dispatched = []
        for m_pad, read_idx in sorted(_group_by_padded_len(reads, self.read_bucket).items()):
            cap = path_cap(m_pad, self.scoring.match, self.scoring.gap)
            b_block = max(1, _FILL_BUDGET // (m_pad * n_pad))
            for start in range(0, len(read_idx), b_block):
                chunk = read_idx[start : start + b_block]
                reads_enc = encode_batch([reads[i] for i in chunk], m_pad, READ_PAD)
                dispatched.append((chunk, reads_enc, cap, trace(reads_enc, _TRACE_CAPACITY, cap)))
        for chunk, reads_enc, cap, outs in dispatched:
            with span("wait", on="readback"):
                best, counts = outs[0].cpu().numpy(), outs[1].cpu().numpy()
            overflow = sorted((k for k in range(len(chunk)) if best[k] > 0 and counts[k] > _TRACE_CAPACITY),
                              key=lambda k: counts[k])
            collect(chunk, outs, skip=set(overflow))
            # Groups of the overflow pairs, fewest cells first, each listed at
            # its largest count with its walk codes inside the fill budget.
            group: List[int] = []
            for k in overflow + [None]:
                if group and (k is None or (len(group) + 1) * int(counts[k]) * cap > _FILL_BUDGET):
                    collect([chunk[g] for g in group], trace(reads_enc[group], int(counts[group[-1]]), cap))
                    group = []
                if k is not None:
                    group.append(k)
        return per_read
