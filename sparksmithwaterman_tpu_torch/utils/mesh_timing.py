"""Scoring time of the mesh strategies beside batch, on the cards of one host.

    python -m sparksmithwaterman_tpu_torch.utils.mesh_timing [--repeats N] [--out FILE]

Builds two workloads: ``long_ref`` (``metrics.engineer_data.long_ref_corpus``,
16 Mbp of references of 8 kb-1 Mb, 256 reads) and ``refseq``
(``refseq_like``, 16 Mbp of 500-4,000 bp references, 512 reads).  For
each it times ``totals`` (scoring only: encode, upload, kernels, the
int64 sums copied to the host) of ``batch`` on the first card, of
``shard_seq``, ``shard_refs`` and ``shard_reads`` on the default mesh
(every card), and of ``shard_seq`` on a mesh of 4 entries of the first
card.  Each strategy's totals must equal batch's.  One warm-up call, then
the median of ``--repeats`` timed calls, each ending in
``torch.cuda.synchronize()``.  Prints the cards' names and power limits,
one line per (workload, strategy), and a JSON line of all medians.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--repeats", type=int, default=5)
    parser.add_argument("--seed", type=int, default=20261016)
    parser.add_argument("--out", default=None, help="also write the lines here")
    args = parser.parse_args(argv)

    import numpy as np
    import torch

    from sparksmithwaterman_tpu_torch.config import AlignConfig
    from sparksmithwaterman_tpu_torch.io import get_reads, get_ref_seqs, iter_files
    from sparksmithwaterman_tpu_torch.metrics.engineer_data import long_ref_corpus, reads_file, refseq_like
    from sparksmithwaterman_tpu_torch.models.aligner import get_backend
    from sparksmithwaterman_tpu_torch.parallel import SeqParallelBackend, build_mesh

    if not torch.cuda.is_available():
        print("mesh_timing: no CUDA device", file=sys.stderr)
        return 1
    cards = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    lines = [f"mesh_timing: {len(cards)} card(s): " + "; ".join(cards)]
    medians = {}
    with tempfile.TemporaryDirectory(prefix="swtorch_mesh_") as work:
        long_root, refseq_root = os.path.join(work, "long_ref"), os.path.join(work, "refseq")
        long_ref_corpus(long_root, 16_000_000, 256, seed=args.seed)
        refseq_like(os.path.join(refseq_root, "refs"), 16_000_000, seed=args.seed + 1)
        reads_file(os.path.join(refseq_root, "inputs", "input1.fa"), 512, seed=args.seed + 2)
        for workload, root in (("long_ref", long_root), ("refseq", refseq_root)):
            reads = get_reads(os.path.join(root, "inputs", "input1.fa"), ">gi")
            refs = [seq for path in iter_files(os.path.join(root, "refs")) for _, seq in get_ref_seqs(path, ">gi")]
            cells = sum(map(len, reads)) * sum(map(len, refs))
            backends = {}
            for strategy in ("batch", "shard_seq", "shard_refs", "shard_reads"):
                config = AlignConfig(ref_dir=root, in_dir=root, out_dir=root, strategy=strategy)
                backends[strategy] = get_backend(config, "cuda:0" if strategy == "batch" else "cuda")
            backends["shard_seq_4x1card"] = SeqParallelBackend(
                AlignConfig(ref_dir=root, in_dir=root, out_dir=root, strategy="shard_seq"),
                build_mesh(axis_names=("seq",), devices=["cuda:0"] * 4),
            )
            want = None
            for name, backend in backends.items():
                backend.totals(reads, refs)  # warm-up
                walls = []
                for _ in range(args.repeats):
                    torch.cuda.synchronize()
                    t = time.perf_counter()
                    totals = backend.totals(reads, refs)
                    torch.cuda.synchronize()
                    walls.append(time.perf_counter() - t)
                if want is None:
                    want = totals
                if not np.array_equal(totals, want):
                    raise RuntimeError(f"mesh_timing: {workload} {name} totals differ from batch's")
                med = statistics.median(walls)
                medians[f"{workload}/{name}"] = med
                mesh = getattr(backend, "mesh", None)
                lines.append(
                    f"{workload:<9} {name:<18} {f'mesh {mesh.shape}' if mesh is not None else backend.device}: "
                    f"median {med:.4f} s of {', '.join(f'{w:.4f}' for w in walls)} "
                    f"({cells / med / 1e9:.1f} real GCUPS; {len(refs)} refs, {len(reads)} reads); totals equal batch's"
                )
                print(lines[-1], flush=True)
    lines.append(json.dumps({"cards": len(cards), "median_s": medians}))
    print(lines[0])
    print(lines[-1])
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
