"""Sequence parallelism: one reference cut along its LENGTH.

Port of :mod:`sparksmithwaterman_tpu.parallel.seqparallel`, the
``shard_seq`` strategy: the reference's DistributeAlgorithm
(``src/sw/DistributedSW.java:118-252``), one DP matrix split across
workers.  Segment ``k`` of every reference lives on entry ``k`` of a
one-axis mesh (``parallel.mesh``), and the DP crosses a segment edge
through one column: with a linear gap, everything left of the edge
reaches the segment only through ``H[:, j0 - 1]``.  Where the JAX ring
passes that column on with ``ppermute``, the port copies it to the next
entry's device (``Tensor.to(dev, non_blocking=True)``; a no-op when both
entries are the same device).

Two forms, as in the JAX package:

- :func:`seqparallel_scores_band` and :class:`SeqParallelBackend` fill
  each (reference chunk, segment) with one K3 launch
  (``ops.cuda_score.band_lane_best``; its plain version on the CPU) and
  take each read's best as the max over segments of K3's start lanes;
- :func:`seqparallel_scores` / :func:`seqparallel_scores_batch` are the
  striped ring of row updates (JAX ``_device_fill``), which the JAX
  package left to XLA: plain torch code here, with the same rounds.

The JAX length ladder, chunk-count padding and fusion cap exist for
compile shapes and VMEM and have no counterpart: K3 takes per-reference
segment widths from a flat buffer, and torch sums in int64 on the device.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from sparksmithwaterman_tpu_torch.io.fasta import READ_PAD, REF_PAD, encode_batch, encode_concat
from sparksmithwaterman_tpu_torch.models.batch_backend import _OUT_BUDGET, TorchBatchBackend, ref_chunks
from sparksmithwaterman_tpu_torch.ops.cuda_score import band_lane_best, carry_elems
from sparksmithwaterman_tpu_torch.ops.packing import pack_reads
from sparksmithwaterman_tpu_torch.parallel.mesh import DeviceMesh, build_mesh, mesh_devices, split_by_bp
from sparksmithwaterman_tpu_torch.utils.profiling import span


def _seq_devices(mesh: DeviceMesh, axis: str) -> list:
    """The mesh's entries in segment order (a one-axis mesh)."""
    if mesh.size != mesh.shape[axis]:
        raise ValueError(f"shard_seq takes a one-axis mesh, got {mesh.shape}")
    return list(mesh.devices.reshape(-1))


# -- the striped ring of row updates (JAX _device_fill) ------------------------


def _row_update(h_prev, read_c, lcol, lprev, seg, ramp, left_ramp, match, mismatch, gap):
    """One DP row of every (ref, read) band: (C, B, Ns) state from the row
    above, the read code (B,), the left column's value on this row lcol
    (C, B) and on the row above lprev (C, B)."""
    sub = torch.where(seg[:, None, :] == read_c[None, :, None], match, mismatch).to(torch.int32)
    nw = torch.cat([lprev[..., None], h_prev[..., :-1]], dim=-1)
    cand = torch.clamp_min(torch.maximum(nw + sub, h_prev + gap), 0)
    chain = torch.cummax(cand - ramp, dim=-1).values + ramp
    return torch.maximum(chain, lcol[..., None] + left_ramp)


def _fill_bands(reads_t: np.ndarray, refs_enc: np.ndarray, match, mismatch, gap, *, stripe, devices):
    """(C, B) int32 best per (ref, read) on devices[0].

    reads_t: (M, B) read codes, M % stripe == 0; refs_enc: (C, N), N a
    multiple of len(devices).  In round t entry k fills stripe t - k of
    its segment from the boundary entry k - 1 produced in round t - 1;
    entry 0 takes zeros.  An idle entry keeps its state and passes zeros
    on, as in the JAX ring."""
    m, b = reads_t.shape
    size = len(devices)
    c, n = refs_enc.shape
    ns = n // size
    num_stripes = m // stripe
    state = []
    for k, dev in enumerate(devices):
        seg = torch.from_numpy(np.ascontiguousarray(refs_enc[:, k * ns : (k + 1) * ns], np.int32)).to(dev)
        state.append({
            "dev": dev,
            "reads": torch.from_numpy(np.ascontiguousarray(reads_t, np.int32)).to(dev),
            "seg": seg,
            "ramp": gap * torch.arange(ns, dtype=torch.int32, device=dev),
            "h": torch.zeros((c, b, ns), dtype=torch.int32, device=dev),
            "best": torch.zeros((c, b), dtype=torch.int32, device=dev),
            "out": torch.zeros((stripe, c, b), dtype=torch.int32, device=dev),
            "corner": torch.zeros((c, b), dtype=torch.int32, device=dev),
        })
    for t in range(num_stripes + size - 1):
        incoming = [None] + [state[k - 1]["out"].to(state[k]["dev"], non_blocking=True) for k in range(1, size)]
        for k, st in enumerate(state):
            in_bound = incoming[k] if k else torch.zeros_like(st["out"])
            s = t - k
            if not 0 <= s < num_stripes:
                st["out"] = torch.zeros_like(st["out"])
                continue
            lprev = torch.cat([st["corner"][None], in_bound[:-1]], dim=0)
            bounds = []
            h = st["h"]
            for r in range(stripe):
                h = _row_update(
                    h, st["reads"][s * stripe + r], in_bound[r], lprev[r], st["seg"],
                    st["ramp"], st["ramp"] + gap, match, mismatch, gap,
                )
                bounds.append(h[..., -1])
                st["best"] = torch.maximum(st["best"], h.amax(dim=-1))
            st["h"] = h
            st["out"] = torch.stack(bounds)
            st["corner"] = in_bound[-1]
    best = state[0]["best"]
    for st in state[1:]:
        best = torch.maximum(best, st["best"].to(devices[0], non_blocking=True))
    return best


def seqparallel_scores(reads, ref, match: int, mismatch: int, gap: int, *, mesh: DeviceMesh, axis: str = "seq",
                       stripe: int = 8) -> torch.Tensor:
    """Max SW score of each read against ONE length-sharded reference.

    reads: read strings, or a pre-encoded (B, M) uint8 array (READ_PAD);
    ref: the reference string, or (N,) uint8 (REF_PAD).  Returns (B,)
    int32 on the mesh's first device, equal to the serial oracle.
    """
    size = mesh.shape[axis]
    if isinstance(reads, np.ndarray):
        reads_enc = reads
    else:
        m = max((len(r) for r in reads), default=1)
        reads_enc = encode_batch(list(reads), max(-(-m // stripe) * stripe, stripe), READ_PAD)
    if reads_enc.shape[1] % stripe:
        pad = -(-reads_enc.shape[1] // stripe) * stripe - reads_enc.shape[1]
        reads_enc = np.pad(reads_enc, ((0, 0), (0, pad)), constant_values=READ_PAD)
    if isinstance(ref, np.ndarray):
        ref_enc = ref
    else:
        ref_enc = encode_batch([ref], max(-(-len(ref) // size) * size, size), REF_PAD)[0]
    if ref_enc.shape[0] % size:
        pad = -(-ref_enc.shape[0] // size) * size - ref_enc.shape[0]
        ref_enc = np.pad(ref_enc, (0, pad), constant_values=REF_PAD)
    return seqparallel_scores_batch(
        reads_enc, ref_enc[None], match, mismatch, gap, mesh=mesh, axis=axis, stripe=stripe
    )[0]


def seqparallel_scores_batch(reads_enc: np.ndarray, refs_enc: np.ndarray, match: int, mismatch: int, gap: int, *,
                             mesh: DeviceMesh, axis: str = "seq", stripe: int = 8) -> torch.Tensor:
    """(C, B) int32 max scores, every reference length-sharded.

    reads_enc: (B, M) uint8, M % stripe == 0; refs_enc: (C, N) uint8,
    N % mesh-axis size == 0.
    """
    devices = _seq_devices(mesh, axis)
    if reads_enc.shape[1] % stripe:
        raise ValueError(f"M={reads_enc.shape[1]} must be a multiple of stripe={stripe}")
    if refs_enc.shape[1] % len(devices):
        raise ValueError(f"N={refs_enc.shape[1]} must divide over {len(devices)} seq shards")
    return _fill_bands(
        np.asarray(reads_enc).T, np.asarray(refs_enc), int(match), int(mismatch), int(gap),
        stripe=int(stripe), devices=devices,
    )


# -- the band ring: one K3 launch per (reference chunk, segment) ---------------


def band_prepack(reads: Sequence[str], devices) -> dict:
    """Packed read rows and start lanes, uploaded once to each distinct
    device (JAX ``band_prepack``: packing and upload, no read block or
    interleave), and the longest read (K3's ``longest``)."""
    m_pack = 128
    longest = max((len(r) for r in reads), default=1)
    while m_pack < longest:
        m_pack *= 2
    packed, start_idx = pack_reads(list(reads), m_pack)
    on = {}
    for dev in devices:
        if dev not in on:
            on[dev] = (torch.from_numpy(packed).to(dev), torch.from_numpy(start_idx.astype(np.int64)).to(dev))
    return dict(m_pack=m_pack, rows=packed.shape[0], longest=longest, on=on)


def _segment_tables(lens: np.ndarray, offsets: np.ndarray, size: int):
    """Per segment s (rows) and reference (columns): the offset and
    available length of segment s, and each reference's segment width
    ns = ceil(len / size) (at least 1).  Segments past a reference's end
    have length 0 and read as REF_PAD."""
    ns = np.maximum(1, -(-lens // size))
    begin = np.arange(size, dtype=np.int64)[:, None] * ns[None, :]
    seg_lens = np.clip(lens[None, :] - begin, 0, ns[None, :])
    seg_offs = np.where(seg_lens > 0, offsets[None, :] + begin, 0)
    return seg_offs.astype(np.int64), seg_lens.astype(np.int32), ns.astype(np.int32)


def _upload_refs(flat: np.ndarray, tables, devices):
    """The flat reference buffer and the segment tables, uploaded once to
    each distinct device: ({device: buffer}, {device: tables})."""
    refs_on, tables_on = {}, {}
    for dev in devices:
        if dev not in refs_on:
            refs_on[dev] = torch.from_numpy(flat).to(dev)
            tables_on[dev] = tuple(torch.from_numpy(t).to(dev) for t in tables)
    return refs_on, tables_on


def _band_ring(pp: dict, refs_on: dict, tables_on: dict, ns: np.ndarray, bounds, params, devices, mark=None) -> list:
    """Per chunk (lo, hi) of ``bounds``: the (hi - lo, R) int32 per-read
    best of references lo..hi-1 of the tables, on the mesh's last entry;
    ``ns`` is the tables' segment widths on the host (K3's carry size).

    Enqueued in rounds, as the JAX ring: in round t entry s fills chunk
    t - s from the right column (and the running per-read max) that entry
    s - 1 made for it in round t - 1, so on separate cards the entries
    work on successive chunks at once.  Entries go last to first within a
    round, and nothing else crosses cards: a copy between cards waits for
    the work queued on both, so each copy is queued before the sender's
    next chunk.  ``mark()`` runs after each round that entry 0 worked in.
    """
    size, n = len(devices), len(bounds)
    carry = [None] * n  # (right column, running max) of each chunk in flight
    out = [None] * n
    for t in range(n + size - 1):
        for s in range(size - 1, -1, -1):
            k = t - s
            if not 0 <= k < n:
                continue
            dev = devices[s]
            lo, hi = bounds[k]
            packed, start_idx = pp["on"][dev]
            seg_offs, seg_lens, ns_t = tables_on[dev]
            if s == 0:
                left = torch.zeros((hi - lo, pp["rows"], pp["m_pack"]), dtype=torch.int32, device=dev)
            else:
                left, best = (x.to(dev, non_blocking=True) for x in carry[k])
            lane, right = band_lane_best(
                packed, refs_on[dev], seg_offs[s, lo:hi], seg_lens[s, lo:hi], ns_t[lo:hi], left, *params,
                carry_cols=int(ns[lo:hi].sum()), longest=pp["longest"],
            )
            scores = lane.reshape(hi - lo, -1).index_select(1, start_idx)
            best = scores if s == 0 else torch.maximum(best, scores)
            carry[k] = None if s == size - 1 else (right, best)
            if s == size - 1:
                out[k] = best
        if mark is not None and t < n:
            mark()
    return out


def seqparallel_scores_band(reads, refs_enc: np.ndarray, match: int, mismatch: int, gap: int, *,
                            mesh: DeviceMesh, axis: str = "seq", prepack: dict | None = None) -> torch.Tensor:
    """(C, R) int32 per-read max scores through the band ring, on the
    mesh's first device.

    reads: read strings (packed here unless a :func:`band_prepack` result
    is given); refs_enc: (C, N) uint8, REF_PAD-padded, N % mesh-axis size
    == 0.  The references form one chunk: one K3 launch per segment.
    """
    devices = _seq_devices(mesh, axis)
    size = len(devices)
    c, n = refs_enc.shape
    if n % size:
        raise ValueError(f"N={n} must divide over {size} seq shards")
    pp = prepack if prepack is not None else band_prepack(reads, devices)
    lens = np.full(c, n, np.int64)
    tables = _segment_tables(lens, np.arange(c, dtype=np.int64) * n, size)
    refs_on, tables_on = _upload_refs(np.ascontiguousarray(refs_enc, np.uint8).reshape(-1), tables, devices)
    (best,) = _band_ring(pp, refs_on, tables_on, tables[2], [(0, c)], (int(match), int(mismatch), int(gap)), devices)
    return best.to(devices[0])


class SeqParallelBackend(TorchBatchBackend):
    """Pipeline backend: every reference length-sharded over the mesh.

    The ``shard_seq`` strategy.  :meth:`totals` (and ``best_of`` /
    ``best_of_async``, inherited) score each chunk of references with
    one K3 launch per segment, segment s on mesh entry s, and sum the
    per-read bests in int64 on the mesh's first device.  The traceback
    (``sites_for_ref``, winners only) is :class:`TorchBatchBackend`'s on
    that device.

    The default mesh is :func:`..parallel.mesh.mesh_devices` of
    ``device`` on one ``seq`` axis.
    """

    def __init__(self, config, mesh: DeviceMesh | None = None, device="cuda"):
        if mesh is None:
            mesh = build_mesh(axis_names=("seq",), devices=mesh_devices(device))
        self.mesh = mesh
        self.axis = mesh.axis_names[0]
        self._devices = _seq_devices(mesh, self.axis)
        super().__init__(config, self._devices[0])
        self._prepack_cache = (None, -1, -1, None)

    def _prepack(self, reads) -> dict:
        """band_prepack of the last reads list (identity, length and total
        bp checked): the pipeline scores one read set against every flush."""
        total_bp = sum(len(r) for r in reads)
        obj, n, bp, pp = self._prepack_cache
        if obj is not reads or n != len(reads) or bp != total_bp:
            pp = band_prepack(reads, self._devices)
            self._prepack_cache = (reads, len(reads), total_bp, pp)
        return pp

    def _chunks(self, lens: np.ndarray, pp: dict) -> List[np.ndarray]:
        """Reference chunks, longest first, each within the K3 output
        budget and the carry budget of its segments (:func:`ref_chunks`).
        On a mesh of more than one entry, at least 2 x size chunks of
        near-equal base pairs, so that entry s works on chunk k while entry
        s + 1 works on chunk k - 1 (the JAX ring pipelines its references
        the same way)."""
        size = len(self._devices)
        parts = split_by_bp(lens, 2 * size) if size > 1 else [np.argsort(-lens, kind="stable")]
        rows, m = pp["rows"], pp["m_pack"]
        return [
            p[sl]
            for p in parts
            for sl in ref_chunks(rows * m, carry_elems(m, rows, 1) * np.maximum(1, -(-lens[p] // size)), _OUT_BUDGET)
        ]

    def _totals_dev(self, reads, ref_seqs):
        pp = self._prepack(reads)
        with span("encode"):
            flat, lens = encode_concat(list(ref_seqs))
            offsets = np.zeros_like(lens)
            np.cumsum(lens[:-1], out=offsets[1:])
        chunks = self._chunks(lens, pp)
        order = np.concatenate(chunks)
        tables = _segment_tables(lens[order], offsets[order], len(self._devices))
        with span("wait", on="upload"):
            refs_on, tables_on = _upload_refs(flat, tables, self._devices)
        order_t = self._upload(order)
        sizes = [len(chunk) for chunk in chunks]
        bounds = [(int(end - size), int(end)) for end, size in zip(np.cumsum(sizes), sizes)]
        events: list = []
        bests = _band_ring(pp, refs_on, tables_on, tables[2], bounds, self._params, self._devices,
                           lambda: self._mark(events))
        totals = torch.zeros(len(ref_seqs), dtype=torch.int64, device=self.device)
        for (lo, hi), best in zip(bounds, bests):
            sums = best.sum(dim=1, dtype=torch.int64).to(self.device, non_blocking=True)
            totals.index_add_(0, order_t[lo:hi], sums)
        cells = sum(len(r) for r in reads) * int(lens.sum())
        return totals, cells
