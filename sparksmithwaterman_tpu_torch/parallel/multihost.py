"""Multi-host runs: the reference manifest sharded over processes, the
winners merged on process 0.

Port of :mod:`sparksmithwaterman_tpu.parallel.multihost` (the reference's
DistributeReference cluster path) over ``torch.distributed``:

- one ``init_process_group("gloo", ...)`` per process
  (:meth:`HostConfig.initialize`);
- the reference *files* are sharded round-robin over processes
  (:func:`shard_manifest`); each process scores its shard on its own
  ``device`` through the backend's kernels, with no communication while
  it scores;
- per input, the processes gather their best totals and reference
  counts (``dist.all_gather`` of one int64 CPU tensor), and the ones
  holding the global best write their ``(file_idx, seq_idx)`` winner
  candidates to the shared output directory; process 0 merges them in
  encounter order, re-reads the winning sequences, traces them and
  writes the report.

Only host integers cross processes, so the group is gloo on CPU tensors
on the card too: NCCL would need a card per rank, and the scoring itself
never touches the group.  Each process journals its shard's result per
input (``resume=True`` replays it while the input and the shard's files
are unchanged).  With ``num_processes == 1`` nothing is initialised and
no collective runs.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from sparksmithwaterman_tpu_torch.config import AlignConfig
from sparksmithwaterman_tpu_torch.io import build_report, get_reads, get_ref_seqs, iter_files
from sparksmithwaterman_tpu_torch.io.report import OptEntry, write_str_to_file
from sparksmithwaterman_tpu_torch.models.aligner import get_backend
from sparksmithwaterman_tpu_torch.models.pipeline import DoubleBufferedFlushes


@dataclasses.dataclass(frozen=True)
class HostConfig:
    """Process topology of a multi-host run (the defaults: one process)."""

    num_processes: int = 1
    process_id: int = 0
    coordinator_address: Optional[str] = None  # "host:port" of rank 0, read as tcp://host:port
    init_method: Optional[str] = None  # a torch.distributed init method, e.g. "file:///shared/path"; wins when set

    def initialize(self) -> None:
        """Join the gloo process group (nothing for one process).  The init
        method is ``init_method``, else ``tcp://<coordinator_address>``,
        else torch's ``env://`` (MASTER_ADDR and MASTER_PORT)."""
        if self.num_processes == 1:
            return
        import torch.distributed as dist

        if not dist.is_available():
            raise RuntimeError("torch.distributed is not available in this torch build")
        init = self.init_method or (f"tcp://{self.coordinator_address}" if self.coordinator_address else "env://")
        dist.init_process_group("gloo", init_method=init, world_size=self.num_processes, rank=self.process_id)


def shard_manifest(files: Sequence[str], num_hosts: int, host_id: int) -> List[Tuple[int, str]]:
    """Round-robin assignment of reference files to hosts: (global file
    index, path), so the merge can restore the serial encounter order."""
    return [(i, f) for i, f in enumerate(files) if i % num_hosts == host_id]


def _allgather_best(local_best: int, host: HostConfig) -> np.ndarray:
    """Every process's ``local_best``, in rank order (int64)."""
    if host.num_processes == 1:
        return np.asarray([local_best], np.int64)
    import torch.distributed as dist

    mine = torch.tensor([local_best], dtype=torch.int64)
    gathered = [torch.zeros_like(mine) for _ in range(host.num_processes)]
    dist.all_gather(gathered, mine)
    return torch.cat(gathered).numpy()


def _barrier(host: HostConfig, name: str) -> None:
    """Wait for every process (``name`` says which point, for a reader of
    a hang)."""
    if host.num_processes == 1:
        return
    import torch.distributed as dist

    dist.barrier()


def _shard_key(in_file: str, my_files: Sequence[Tuple[int, str]]) -> str:
    """Identity of one (input, manifest shard) task: a shard's result is a
    function of the input file and the shard's reference files, so its
    journal entry holds while none of their mtimes changed."""
    h = hashlib.sha256()
    h.update(f"{in_file}:{os.path.getmtime(in_file)}".encode())
    for idx, f in my_files:
        h.update(f"{idx}:{f}:{os.path.getmtime(f)}".encode())
    return h.hexdigest()[:16]


def _read_journal(path: str, key: str) -> Optional[dict]:
    """The journal entry at ``path`` if it holds ``key``; None when there
    is none, it is for other inputs, or it cannot be read."""
    if not os.path.exists(path):
        return None
    try:
        with open(path) as f:
            entry = json.load(f)
    except (json.JSONDecodeError, OSError):
        return None  # a torn write: score the shard again
    return entry if entry.get("key") == key else None


def run_multihost_pipeline(
    config: AlignConfig,
    host: HostConfig = HostConfig(),
    backend=None,
    resume: bool = False,
    device="cuda",
) -> List[str]:
    """The pipeline with the reference files sharded over processes.

    Every process sees the same in_dir, ref_dir and out_dir (a shared
    filesystem).  ``backend`` defaults to ``get_backend(config, device)``.
    Process 0 writes the reports; every process returns their paths.
    With ``resume=True`` a process whose per-shard journal matches the
    current input and shard replays the journaled result and scores
    nothing.
    """
    if backend is None:
        backend = get_backend(config, device)
    files = list(iter_files(config.ref_dir))
    my_files = shard_manifest(files, host.num_processes, host.process_id)
    partial_dir = os.path.join(config.out_dir, ".partial")

    out_paths: List[str] = []
    input_num = 0
    for in_file in iter_files(config.in_dir):
        input_num += 1
        reads = get_reads(in_file, config.delimiter)
        t0 = time.monotonic()

        journal_path = os.path.join(partial_dir, f"input{input_num}.host{host.process_id}.journal.json")
        shard_key = _shard_key(in_file, my_files)
        journaled = _read_journal(journal_path, shard_key) if resume else None
        if journaled is not None:
            local_max = int(journaled["local_max"])
            local_refs = int(journaled["local_refs"])
            winners = [tuple(w) for w in journaled["winners"]]
        else:
            # Winner candidates are (file_idx, seq_idx) pairs only: the
            # sequences are read again from the shared files at the merge.
            merge = DoubleBufferedFlushes(backend, reads)
            pending: List[Tuple[int, int]] = []
            seqs: List[str] = []
            pending_bp = 0
            local_refs = 0
            for file_idx, ref_file in my_files:
                ref_seqs = get_ref_seqs(ref_file, config.delimiter)
                local_refs += len(ref_seqs)
                for seq_idx, (_, seq) in enumerate(ref_seqs):
                    pending.append((file_idx, seq_idx))
                    seqs.append(seq)
                    pending_bp += len(seq)
                    if pending_bp >= config.ref_batch_bp:
                        merge.dispatch(pending, seqs)
                        pending, seqs, pending_bp = [], [], 0
            merge.dispatch(pending, seqs)
            merge.finish()
            local_max, winners = merge.best, merge.winners
            os.makedirs(partial_dir, exist_ok=True)
            tmp = journal_path + ".tmp"
            with open(tmp, "w") as f:
                json.dump({"key": shard_key, "local_max": local_max, "local_refs": local_refs, "winners": winners}, f)
            os.replace(tmp, journal_path)  # atomic: no torn journal

        global_max = int(_allgather_best(local_max, host).max())
        all_refs = int(_allgather_best(local_refs, host).sum())

        # The processes holding the global best leave their candidates on
        # the shared filesystem; the others leave an empty list.
        os.makedirs(partial_dir, exist_ok=True)
        with open(os.path.join(partial_dir, f"input{input_num}.host{host.process_id}.json"), "w") as f:
            json.dump(winners if local_max == global_max else [], f)
        _barrier(host, f"candidates-{input_num}")

        out_path = os.path.join(config.out_dir, f"{config.out_name}{input_num}{config.out_ext}")
        if host.process_id == 0:
            merged: List[Tuple[int, int]] = []
            for pid in range(host.num_processes):
                with open(os.path.join(partial_dir, f"input{input_num}.host{pid}.json")) as f:
                    merged.extend(tuple(x) for x in json.load(f))
            merged.sort()  # the serial encounter order
            parsed: dict = {}
            opt: List[OptEntry] = []
            for file_idx, seq_idx in merged:
                if file_idx not in parsed:
                    parsed[file_idx] = get_ref_seqs(files[file_idx], config.delimiter)
                metadata, seq = parsed[file_idx][seq_idx]
                opt.append(((metadata, seq), backend.sites_for_ref(seq, reads)))
            exec_ms = int((time.monotonic() - t0) * 1000)
            opt.sort(key=lambda entry: entry[0][0])
            report = build_report(
                reads=reads,
                num_refs=all_refs,
                num_reads=len(reads),
                max_score=global_max,
                exec_time_ms=exec_ms,
                opt=opt,
            )
            write_str_to_file(out_path, report)
        _barrier(host, f"report-{input_num}")
        out_paths.append(out_path)
    return out_paths
