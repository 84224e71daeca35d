"""The correctness check's control and its planted faults.

    python3 -m swbench.control --workload <cell> --seeds 1,2,3 --seconds 10 [--patch control]

Runs the cell as ``swbench/run.py`` does, with one patch in place from
before the backend is made until the window ends, once per seed in one
process, and prints each run's compared numbers as a JSON line.  The
benchmark's own runs never load this module.

- ``control``: the reference put in the traceback's place, computed with
  one guarantee broken: each read keeps its first max cell alone, as a
  tracer of capacity 1 would (the configurations state every co-optimal
  site);
- ``half_batch``: each flush scores half of the reads and doubles the
  totals (half of the batch left out, the mean taken over the rest);
- ``no_exchange``: only the first refs-axis entry's per-reference sums
  reach the totals (the exchange between cards left out);
- ``altered_site``: the first site of each traced winner has one base of
  its aligned read changed where the traceback produces it;
- ``altered_score``: K1's output lanes are one higher where K1 produces
  them;
- ``dropped_report``: the pipeline writes no report.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time

import numpy as np

from swbench.reference import smith_waterman as sw

_CODES = np.full(256, 255, np.uint8)
for _k, _c in enumerate(b"ACGT"):
    _CODES[_c] = _k
    _CODES[ord(chr(_c).lower())] = _k


def _codes(seq: str) -> np.ndarray:
    return _CODES[np.frombuffer(seq.encode("ascii"), np.uint8)]


@contextlib.contextmanager
def _swap(owner, name: str, make):
    old = owner.__dict__[name] if isinstance(owner, type) else getattr(owner, name)
    setattr(owner, name, make(old))
    try:
        yield
    finally:
        setattr(owner, name, old)


def control():
    """The reference, first max cell alone, in the traceback's place."""
    from sparksmithwaterman_tpu_torch.models.batch_backend import TorchBatchBackend

    def make(_old):
        def sites_for_ref(self, ref_seq, reads):
            s = self.scoring
            _, per_read = sw.read_sites([_codes(r) for r in reads], _codes(ref_seq), (s.match, s.mismatch, s.gap),
                                        self.device, s.gap_char, s.tie_semantics, first_only=True)
            return sw.winner_sites(per_read)
        return sites_for_ref

    return _swap(TorchBatchBackend, "sites_for_ref", make)


def half_batch():
    from sparksmithwaterman_tpu_torch.models.batch_backend import TorchBatchBackend

    def make(old):
        def _dispatch_cols(self, reads, ref_seqs):
            pending, cells = old(self, list(reads[: max(1, len(reads) // 2)]), ref_seqs)
            return [(idx, col * 2) for idx, col in pending], cells
        return _dispatch_cols

    return _swap(TorchBatchBackend, "_dispatch_cols", make)


def no_exchange():
    from sparksmithwaterman_tpu_torch.parallel import engine

    def make(old):
        def _dispatch_packed(self, reads, ref_seqs):
            pending, cells = old(self, reads, ref_seqs)
            lens = np.fromiter((len(s) for s in ref_seqs), np.int64, len(ref_seqs))
            first = set(engine.split_by_bp(lens, self._dc)[0].tolist())
            return [(idx, col) for idx, col in pending if set(idx.cpu().tolist()) <= first], cells
        return _dispatch_packed

    return _swap(engine.ShardedBackend, "_dispatch_packed", make)


def altered_site():
    from sparksmithwaterman_tpu_torch.models.batch_backend import TorchBatchBackend

    def make(old):
        def sites_for_ref(self, ref_seq, reads):
            sites = old(self, ref_seq, reads)
            if sites:
                index, (aligned_ref, aligned_read) = sites[0]
                flip = "C" if aligned_read[-1] != "C" else "G"
                sites[0] = (index, (aligned_ref, aligned_read[:-1] + flip))
            return sites
        return sites_for_ref

    return _swap(TorchBatchBackend, "sites_for_ref", make)


def altered_score():
    from sparksmithwaterman_tpu_torch.models import batch_backend
    from sparksmithwaterman_tpu_torch.parallel import engine

    def make(old):
        def lane_best_packed_varlen(*args, **kwargs):
            return old(*args, **kwargs) + 1
        return lane_best_packed_varlen

    stack = contextlib.ExitStack()
    for module in (batch_backend, engine):
        stack.enter_context(_swap(module, "lane_best_packed_varlen", make))
    return stack


def dropped_report():
    from sparksmithwaterman_tpu_torch.models import pipeline

    return _swap(pipeline, "write_str_to_file", lambda _old: lambda path, data: False)


PATCHES = {"control": control, "half_batch": half_batch, "no_exchange": no_exchange,
           "altered_site": altered_site, "altered_score": altered_score, "dropped_report": dropped_report}


def main(argv=None) -> int:
    from swbench import run

    parser = argparse.ArgumentParser(description="The correctness check's control and planted faults.")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True, help="comma-separated")
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--patch", choices=sorted(PATCHES) + ["none"], default="control")
    args = parser.parse_args(argv)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        patch = None if args.patch == "none" else PATCHES[args.patch]()
        result = run.run_cell(args.workload, seed, args.seconds, False, "cuda", t_start=t0, patch=patch)
        print(json.dumps({"patch": args.patch, "workload": args.workload, "seed": seed,
                          "correct": result["correct"], "attempted": result["attempted"],
                          "metrics": result["metrics"], "checks": result["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
