"""Sharded alignment engine: the ``shard_refs`` and ``shard_reads``
strategies on a ``("refs", "reads")`` device mesh.

Port of :mod:`sparksmithwaterman_tpu.parallel.engine`:
:class:`ShardedBackend` (packed and unpacked paths) and the unpacked mesh
functions :func:`sharded_score_grid` and :func:`sharded_totals`.

- **shard_refs** — the reference's DistributeReference
  (``src/sw/Distribution.java:227-373``): each refs-axis entry scores a
  share of the flush's references, balanced by base pairs, longest first;
- **shard_reads** — its declared DistributeReads
  (``src/sw/Distribution.java:440-468``): each reads-axis entry scores
  its share of every pack's rows.

On the packed path every (reads, refs) block is one K1 launch
(``ops.cuda_score.lane_best_packed_varlen``) per reference chunk on its
entry's device; on the unpacked path (``pack_reads=False`` or
``kernel='row'``) each block of an (R, C) grid is one K4 or K5 launch.
The blocks' int64 per-reference sums move to the mesh's first device and
are added there, in place of the JAX ``psum``.  The winner reduce and the
traceback are :class:`TorchBatchBackend`'s, on that device.

The JAX package's grouped long-reference fallback (``_packed_col_sums``)
has no counterpart: K1 takes every reference length.  Nor does its shard
padding (reads to ``_quantize_15(r, 8 * dr)``, references to ``8 * dc``
multiples): the blocks here may differ in size by one row or column.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from sparksmithwaterman_tpu_torch.config import AlignConfig
from sparksmithwaterman_tpu_torch.io.fasta import encode_concat
from sparksmithwaterman_tpu_torch.models.batch_backend import (
    _INT32_SAFE,
    _OUT_BUDGET,
    TorchBatchBackend,
    _col_sums,
    _score_grid,
    ref_chunks,
)
from sparksmithwaterman_tpu_torch.ops.cuda_score import carry_elems, lane_best_packed_varlen
from sparksmithwaterman_tpu_torch.ops.packing import packed_col_sums
from sparksmithwaterman_tpu_torch.parallel.mesh import DeviceMesh, build_mesh, mesh_devices, split_by_bp
from sparksmithwaterman_tpu_torch.utils.profiling import span


def _shares(total: int, parts: int) -> List[slice]:
    """``parts`` contiguous slices of range(total), sizes differing by at
    most one, the larger first."""
    per, extra = divmod(total, parts)
    bounds = np.cumsum([0] + [per + (k < extra) for k in range(parts)])
    return [slice(int(lo), int(hi)) for lo, hi in zip(bounds[:-1], bounds[1:])]


def _stage_grid(reads_enc: np.ndarray, refs_enc: np.ndarray, mesh: DeviceMesh, reads_axis: str, refs_axis: str) -> list:
    """The blocks of an (R, C) grid on a mesh, every input uploaded before
    any launch: [(read rows, ref columns, reads on the entry's device, refs
    there)].  Reads split over ``reads_axis`` and references over
    ``refs_axis`` in near-equal contiguous shares; empty blocks are left
    out.  Each share is uploaded once per distinct device."""
    names = mesh.axis_names
    if mesh.size != mesh.shape.get(refs_axis, 0) * mesh.shape.get(reads_axis, 0):
        raise ValueError(f"axes {refs_axis!r} and {reads_axis!r} must hold the whole mesh {mesh.shape}")
    grid = np.moveaxis(mesh.devices, (names.index(refs_axis), names.index(reads_axis)), (0, 1))
    grid = grid.reshape(mesh.shape[refs_axis], mesh.shape[reads_axis])
    on: dict = {}

    def upload(arr, sl, dev, key):
        if (key, sl.start, dev) not in on:
            with span("wait", on="upload"):
                on[(key, sl.start, dev)] = torch.from_numpy(np.ascontiguousarray(arr[sl])).to(dev)
        return on[(key, sl.start, dev)]

    blocks = []
    for j, cols in enumerate(_shares(refs_enc.shape[0], grid.shape[0])):
        for i, rows in enumerate(_shares(reads_enc.shape[0], grid.shape[1])):
            if rows.stop > rows.start and cols.stop > cols.start:
                dev = grid[j, i]
                blocks.append((rows, cols, upload(reads_enc, rows, dev, "reads"), upload(refs_enc, cols, dev, "refs")))
    return blocks


def _check_kernel(kernel: str) -> None:
    if kernel not in ("diag", "row"):
        raise ValueError(f"kernel must be 'diag' or 'row', got {kernel!r}")


def sharded_score_grid(reads, refs, match, mismatch, gap, *, mesh: DeviceMesh, reads_axis="reads",
                       refs_axis="refs", kernel="diag") -> torch.Tensor:
    """(R, C) int32 best score of every (read, ref) pair, with reads split
    over ``reads_axis`` and references over ``refs_axis`` of the mesh.

    reads: (R, M) uint8, READ_PAD-padded; refs: (C, N) uint8, REF_PAD-
    padded (NumPy arrays).  Each block is one K4 (``kernel='diag'``) or
    K5 (``'row'``) launch on its entry's device; the grid is gathered on
    the mesh's first device after the last launch.  Any R and C: the JAX
    function's divisibility rule has no counterpart.
    """
    _check_kernel(kernel)
    reads, refs = np.asarray(reads, np.uint8), np.asarray(refs, np.uint8)
    params = (int(match), int(mismatch), int(gap))
    blocks = _stage_grid(reads, refs, mesh, reads_axis, refs_axis)
    grids = [(rows, cols, _score_grid(r, f, params, kernel)) for rows, cols, r, f in blocks]
    first = mesh.devices.reshape(-1)[0]
    out = torch.zeros((reads.shape[0], refs.shape[0]), dtype=torch.int32, device=first)
    for rows, cols, g in grids:
        out[rows, cols] = g.to(first, non_blocking=True)
    return out


def sharded_totals(reads, refs, match, mismatch, gap, *, mesh: DeviceMesh, reads_axis="reads",
                   refs_axis="refs", kernel="diag") -> torch.Tensor:
    """(C,) int64 per-reference totals over all reads, on the mesh's first
    device: each block's sums over its reads (int64, on its entry's
    device) are added there after the last launch, in place of the JAX
    ``psum`` over the reads axis.  Arguments as :func:`sharded_score_grid`.
    """
    _check_kernel(kernel)
    reads, refs = np.asarray(reads, np.uint8), np.asarray(refs, np.uint8)
    params = (int(match), int(mismatch), int(gap))
    blocks = _stage_grid(reads, refs, mesh, reads_axis, refs_axis)
    sums = _col_sums(blocks, params, kernel)
    first = mesh.devices.reshape(-1)[0]
    totals = torch.zeros(refs.shape[0], dtype=torch.int64, device=first)
    for cols, col in sums:
        totals[cols] += col.to(first, non_blocking=True)
    return totals


class ShardedBackend(TorchBatchBackend):
    """Multi-device backend: TorchBatchBackend's packing and reduce with
    the scoring spread over a ``("refs", "reads")`` mesh.

    The default mesh holds :func:`..parallel.mesh.mesh_devices` of
    ``device``: on the refs axis for ``strategy='shard_refs'``, on the
    reads axis for ``'shard_reads'``; a rectangular mesh combines both.
    A mesh of one entry is exactly :class:`TorchBatchBackend`.
    """

    def __init__(self, config: AlignConfig, mesh: Optional[DeviceMesh] = None, device="cuda"):
        if mesh is None:
            devs = mesh_devices(device)
            n = len(devs)
            mesh = build_mesh((1, n) if config.strategy == "shard_reads" else (n, 1), devices=devs)
        self.mesh = mesh
        self._dr = mesh.shape["reads"]
        self._dc = mesh.shape["refs"]
        super().__init__(config, mesh.devices.reshape(-1)[0])

    def _row_share(self, pack: dict, i: int, dev) -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
        """Rows of ``pack`` for reads-axis entry i on ``dev`` and the start
        lanes of the reads that begin there (relative to those rows); None
        when the share holds no read.  Cached in the pack."""
        shares = pack.setdefault("shares", {})
        if (i, dev) not in shares:
            rows, m = pack["rows"], pack["m_pack"]
            per = -(-rows // self._dr)
            lo, hi = min(rows, i * per), min(rows, (i + 1) * per)
            start = pack["start_idx"]
            local = start[(start >= lo * m) & (start < hi * m)] - lo * m
            with span("wait", on="upload"):
                shares[(i, dev)] = None if local.numel() == 0 else (pack["packed"][lo:hi].to(dev), local.to(dev))
        return shares[(i, dev)]

    def _stage(self, reads_enc, refs_enc):
        """The unpacked path's blocks over the mesh (see
        :func:`_stage_grid`); the inherited dispatch launches K4 or K5 per
        block and its sums meet on the first device."""
        return _stage_grid(reads_enc, refs_enc, self.mesh, "reads", "refs")

    def _dispatch_packed(self, reads, ref_seqs):
        """One K1 dispatch per (mesh entry x pack share x reference chunk),
        not waited on.  Returns ([(ref indices on the first device, (C,)
        int64 sums on the entry's device)], real cells).

        Every input is uploaded before the first launch, and the sums
        cross to the first device only in :meth:`_totals_dev`: an upload
        from pageable host memory, like a copy between cards, waits for
        the work already queued on its device."""
        if self.mesh.size == 1:
            return super()._dispatch_packed(reads, ref_seqs)
        packs = self._pack_chunks(reads, max(1, _INT32_SAFE // max(1, self.scoring.match)))
        with span("encode"):
            lens_all = np.fromiter((len(s) for s in ref_seqs), np.int64, len(ref_seqs))
            parts = split_by_bp(lens_all, self._dc)
        order_t = self._upload(np.concatenate(parts))
        jobs = []  # (ref indices, ref lengths, flat refs, lens, offsets, [(packed rows, start lanes)])
        lo = 0
        for j, part in enumerate(parts):
            idx_t, lo = order_t[lo : lo + len(part)], lo + len(part)
            if not len(part):
                continue
            with span("encode"):
                flat, lens = encode_concat([ref_seqs[k] for k in part])
                offsets = np.zeros_like(lens)
                np.cumsum(lens[:-1], out=offsets[1:])
            for i in range(self._dr):
                dev = self.mesh.devices[j, i]
                shares = [(*share, pack["longest"]) for pack in packs
                          if (share := self._row_share(pack, i, dev)) is not None]
                with span("wait", on="upload"):
                    inputs = (torch.from_numpy(flat).to(dev), torch.from_numpy(lens.astype(np.int32)).to(dev),
                              torch.from_numpy(offsets).to(dev))
                jobs.append((idx_t, lens, *inputs, shares))
        pending: List[Tuple[torch.Tensor, torch.Tensor]] = []
        events: list = []
        for idx_t, lens, flat_t, lens_t, offsets_t, shares in jobs:
            for packed, start, longest in shares:
                rows, m_pack = packed.shape  # each pack at its own lane tier
                carry = carry_elems(m_pack, rows, 1) * lens  # the int32 form's: an upper bound of the s16x2 form's
                for sl in ref_chunks(rows * m_pack, carry, _OUT_BUDGET):
                    lane = lane_best_packed_varlen(packed, flat_t, lens_t[sl], *self._params, offsets=offsets_t[sl],
                                                   carry_cols=int(lens[sl].sum()), longest=longest)
                    pending.append((idx_t[sl], packed_col_sums(lane, start)))
                    self._mark(events)
        cells = sum(pack["read_bp"] for pack in packs) * int(lens_all.sum())
        return pending, cells
