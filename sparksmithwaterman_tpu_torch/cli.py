"""Command-line interface of the port: ``swtorch align`` and ``swtorch
scaling``.

The ``align`` and ``scaling`` subcommands of ``sparksmithwaterman_tpu.cli``
with the same flags, plus ``--device`` (default ``cuda``).  A CUDA device
that is not available is an error: the command exits non-zero and does
not run on the CPU instead.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys

import torch

_STRATEGIES = ["serial", "batch", "wavefront", "shard_refs", "shard_reads", "shard_seq"]


def _add_align(sub) -> None:
    p = sub.add_parser("align", help="run the alignment pipeline")
    p.add_argument("--ref-dir", required=True)
    p.add_argument("--in-dir", required=True)
    p.add_argument("--out-dir", required=True)
    p.add_argument("--out-name", default="result")
    p.add_argument("--out-ext", default=".txt")
    p.add_argument("--delimiter", default=">gi")
    p.add_argument("--match", type=int, default=5)
    p.add_argument("--mismatch", type=int, default=-3)
    p.add_argument("--gap", type=int, default=-4)
    p.add_argument("--strategy", default="batch", choices=_STRATEGIES)
    p.add_argument(
        "--tie-semantics",
        default="serial",
        choices=["serial", "distributed"],
        help="tied-path direction engine: 'serial' = SmithWaterman.GetCellScore "
        "(ties a>i>d), 'distributed' = DistributedSW.GetCellScore (strict '>', ties d>i>a)",
    )
    p.add_argument(
        "--resume",
        action="store_true",
        help="skip input files already completed per the out-dir journal",
    )
    p.add_argument(
        "--profile-dir",
        default=None,
        help="write a torch.profiler chrome trace of the run to this directory",
    )
    p.add_argument("--device", default="cuda", help="torch device to run on (default: cuda)")


def _add_scaling(sub) -> None:
    p = sub.add_parser("scaling", help="multi-device strong-scaling sweep (refs or seq mesh axis)")
    p.add_argument(
        "--axis",
        default="refs",
        choices=["refs", "seq"],
        help="refs = shard the reference set; seq = length-shard ONE reference",
    )
    p.add_argument(
        "--devices",
        default=None,
        help="comma-separated device counts, e.g. 1,2,4 (default: powers of 2 up to available)",
    )
    p.add_argument("--num-reads", type=int, default=32)
    p.add_argument("--read-len", type=int, default=64)
    p.add_argument("--num-refs", type=int, default=64)
    p.add_argument("--ref-len", type=int, default=512)
    p.add_argument("--device", default="cuda", help="torch device: cuda = every card of the host (default)")


def _scaling(args) -> int:
    from sparksmithwaterman_tpu_torch.metrics.scaling import measure_scaling

    rows = measure_scaling(
        [int(x) for x in args.devices.split(",")] if args.devices else None,
        num_reads=args.num_reads,
        read_len=args.read_len,
        num_refs=args.num_refs,
        ref_len=args.ref_len,
        axis=args.axis,
        device=args.device,
    )
    print(json.dumps(rows, indent=1))
    return 0


@contextlib.contextmanager
def _profiled(log_dir, device: torch.device):
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="swtorch",
        description="Smith-Waterman alignment engine on PyTorch and CUDA",
    )
    sub = parser.add_subparsers(dest="command", required=True)
    _add_align(sub)
    _add_scaling(sub)
    args = parser.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print(f"swtorch: device {args.device!r} requested but CUDA is not available", file=sys.stderr)
        return 2
    if args.command == "scaling":
        return _scaling(args)

    from sparksmithwaterman_tpu_torch.config import AlignConfig, ScoringScheme
    from sparksmithwaterman_tpu_torch.models.aligner import get_backend
    from sparksmithwaterman_tpu_torch.models.pipeline import run_pipeline
    config = AlignConfig(
        ref_dir=args.ref_dir,
        in_dir=args.in_dir,
        out_dir=args.out_dir,
        out_name=args.out_name,
        out_ext=args.out_ext,
        delimiter=args.delimiter,
        scoring=ScoringScheme(
            match=args.match,
            mismatch=args.mismatch,
            gap=args.gap,
            tie_semantics=args.tie_semantics,
        ),
        strategy=args.strategy,
    )
    backend = get_backend(config, device)
    with _profiled(args.profile_dir, device):
        paths = run_pipeline(config, backend=backend, resume=args.resume)
    for p in paths:
        print(p)
    return 0


if __name__ == "__main__":
    sys.exit(main())
