"""The directory pipeline of the port: crawl inputs, score every read
against the reference set in flushes, trace the winners, write reports.

Port of ``sparksmithwaterman_tpu.models.pipeline.run_pipeline`` with the
same loop, journal and report bytes.  The winner merge keeps encounter
order: a flush total ``>`` the best replaces the winners, ``==`` appends.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, List, Tuple

from sparksmithwaterman_tpu_torch.config import AlignConfig
from sparksmithwaterman_tpu_torch.io import build_report, get_reads, get_ref_seqs, iter_files
from sparksmithwaterman_tpu_torch.io.report import OptEntry, write_str_to_file
from sparksmithwaterman_tpu_torch.models.aligner import get_backend
from sparksmithwaterman_tpu_torch.utils.profiling import span

_JOURNAL = ".journal.jsonl"


class DoubleBufferedFlushes:
    """Encounter-order winner merge over scoring flushes, double-buffered:
    flush k's (best, tie indices) is resolved only after flush k+1 has been
    dispatched, so the device tail and the copy hide behind the next
    flush's parse and encode.  Backends without ``best_of_async`` resolve
    at once."""

    def __init__(self, backend, reads):
        self.best = 0
        self.winners: list = []
        self._in_flight: list = []
        self._reads = reads
        async_fn = getattr(backend, "best_of_async", None)
        if async_fn is None:
            def async_fn(reads_, seqs, _b=backend):
                res = _b.best_of(reads_, seqs)
                return lambda: res

        self._async = async_fn

    def dispatch(self, entries: list, seqs: list) -> None:
        if not entries:
            return
        self._in_flight.append((entries, self._async(self._reads, seqs)))
        while len(self._in_flight) > 1:
            self._drain_one()

    def _drain_one(self) -> None:
        entries, resolve = self._in_flight.pop(0)
        with span("wait", on="resolve"):
            best, ties = resolve()
        if best > self.best:
            self.best = best
            self.winners = [entries[i] for i in ties]
        elif best == self.best:
            self.winners.extend(entries[i] for i in ties)

    def finish(self) -> None:
        while self._in_flight:
            self._drain_one()


def _journal_path(config: AlignConfig) -> str:
    return os.path.join(config.out_dir, _JOURNAL)


def _load_journal(config: AlignConfig) -> Dict[str, dict]:
    """Completed input files of an earlier run, by input path."""
    path = _journal_path(config)
    done: Dict[str, dict] = {}
    if os.path.exists(path):
        with open(path) as f:
            for line in f:
                line = line.strip()
                if line:
                    entry = json.loads(line)
                    done[entry["input"]] = entry
    return done


def _journal_append(config: AlignConfig, entry: dict) -> None:
    path = _journal_path(config)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "a") as f:
        f.write(json.dumps(entry) + "\n")


def run_pipeline(
    config: AlignConfig, backend=None, resume: bool = False, device="cuda"
) -> List[str]:
    """Run the comparison for every input file; return the report paths.

    ``backend`` defaults to ``get_backend(config, device)``.  With
    ``resume=True``, input files already recorded in the out-dir journal
    (same path and mtime, report present) are skipped and their report
    paths returned.
    """
    if backend is None:
        backend = get_backend(config, device)
    done = _load_journal(config) if resume else {}

    out_paths: List[str] = []
    input_num = 0
    for in_file in iter_files(config.in_dir):
        input_num += 1
        prior = done.get(in_file)
        if (
            prior
            and prior.get("mtime") == os.path.getmtime(in_file)
            and os.path.exists(prior["report"])
        ):
            out_paths.append(prior["report"])
            continue
        with span("file", path=in_file):
            out_paths.append(_run_file(config, backend, in_file, input_num))
    return out_paths


def _run_file(config: AlignConfig, backend, in_file: str, input_num: int) -> str:
    """Score one input file against the reference tree, trace its winners
    and write its report and journal line; returns the report's path."""
    with span("parse", what="reads"):
        reads = get_reads(in_file, config.delimiter)

    t0 = time.monotonic()
    num_refs = 0
    # Reference files stream in; sequences accumulate across files up
    # to ref_batch_bp base pairs per scoring flush.
    merge = DoubleBufferedFlushes(backend, reads)
    pending: List[Tuple[str, str]] = []
    pending_bp = 0
    for ref_file in iter_files(config.ref_dir):
        with span("parse", what="refs"):
            ref_seqs = get_ref_seqs(ref_file, config.delimiter)
        num_refs += len(ref_seqs)
        for metadata, seq in ref_seqs:
            pending.append((metadata, seq))
            pending_bp += len(seq)
            if pending_bp >= config.ref_batch_bp:
                merge.dispatch(pending, [s for _, s in pending])
                pending, pending_bp = [], 0
    merge.dispatch(pending, [s for _, s in pending])
    merge.finish()

    # Traceback of the winning references only.
    opt: List[OptEntry] = [
        ((metadata, seq), backend.sites_for_ref(seq, reads))
        for metadata, seq in merge.winners
    ]
    exec_ms = int((time.monotonic() - t0) * 1000)

    with span("report"):
        opt.sort(key=lambda entry: entry[0][0])
        report = build_report(
            reads=reads,
            num_refs=num_refs,
            num_reads=len(reads),
            max_score=merge.best,
            exec_time_ms=exec_ms,
            opt=opt,
        )
        out_path = os.path.join(config.out_dir, f"{config.out_name}{input_num}{config.out_ext}")
        write_str_to_file(out_path, report)
        _journal_append(
            config,
            {
                "input": in_file,
                "mtime": os.path.getmtime(in_file),
                "report": out_path,
                "max_score": merge.best,
                "exec_ms": exec_ms,
            },
        )
    return out_path
