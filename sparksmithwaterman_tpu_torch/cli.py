"""Command-line interface of the port, ``swtorch``.

The subcommands of ``sparksmithwaterman_tpu.cli`` with the same flags,
defaults, printed lines and exit codes:

- ``align``   — run the comparison pipeline (any strategy);
- ``info``    — reference dataset statistics (``--threads`` for a pool);
- ``gen``     — the synthetic sweep corpora;
- ``bench``   — the execution-time sweeps over a ``gen`` tree (the port's
  headline bench is ``python -m sparksmithwaterman_tpu_torch.bench``);
- ``diff``    — two strategies on the same data, reports compared apart
  from the time line (exit 1 when they diverge);
- ``scaling`` — the multi-device strong-scaling sweep.

``align``, ``bench``, ``diff`` and ``scaling`` also take ``--device``
(default ``cuda``).  A CUDA device that is not available is an error:
the command exits 2 and does not run on the CPU instead.  ``info`` and
``gen`` use no device.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

_STRATEGIES = ["serial", "batch", "wavefront", "shard_refs", "shard_reads", "shard_seq"]
_SWEEPS = ["read_num", "read_len", "ref_num", "ref_len"]


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


def _add_info(sub) -> None:
    p = sub.add_parser("info", help="reference dataset statistics")
    p.add_argument("--ref-dir", required=True)
    p.add_argument("--out-file", required=True)
    p.add_argument("--delimiter", default=">gi")
    p.add_argument("--threads", type=int, default=1, help="parse files on a pool of this many threads")


def _add_gen(sub) -> None:
    p = sub.add_parser("gen", help="generate synthetic benchmark corpora")
    p.add_argument("--out-dir", required=True)
    p.add_argument("--sweeps", nargs="+", default=list(_SWEEPS), choices=_SWEEPS)
    p.add_argument("--scale", type=float, default=1.0, help="shrink sweep sizes (1.0 = the reference's full corpus)")


def _add_bench(sub) -> None:
    p = sub.add_parser("bench", help="execution-time sweeps")
    p.add_argument("--data-dir", required=True, help="dir from `gen`")
    p.add_argument("--out-dir", required=True)
    p.add_argument("--strategy", default="batch")
    p.add_argument("--sweeps", nargs="+", default=list(_SWEEPS), choices=_SWEEPS)
    p.add_argument("--device", default="cuda", help="torch device to run on (default: cuda)")


def _add_diff(sub) -> None:
    p = sub.add_parser("diff", help="run two strategies on the same data and diff the reports")
    p.add_argument("--ref-dir", required=True)
    p.add_argument("--in-dir", required=True)
    p.add_argument("--out-dir", required=True)
    p.add_argument("--delimiter", default=">gi")
    p.add_argument("--match", type=int, default=5)
    p.add_argument("--mismatch", type=int, default=-3)
    p.add_argument("--gap", type=int, default=-4)
    p.add_argument("--tie-semantics", default="serial", choices=["serial", "distributed"])
    p.add_argument("--strategy-a", default="serial", choices=_STRATEGIES)
    p.add_argument("--strategy-b", default="batch", choices=_STRATEGIES)
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


def _scoring(args):
    from sparksmithwaterman_tpu_torch.config import ScoringScheme

    return ScoringScheme(match=args.match, mismatch=args.mismatch, gap=args.gap, tie_semantics=args.tie_semantics)


def _align(args, device: torch.device) -> int:
    from sparksmithwaterman_tpu_torch.config import AlignConfig
    from sparksmithwaterman_tpu_torch.models.aligner import get_backend
    from sparksmithwaterman_tpu_torch.models.pipeline import run_pipeline
    from sparksmithwaterman_tpu_torch.utils.profiling import profiler_trace

    config = AlignConfig(
        ref_dir=args.ref_dir,
        in_dir=args.in_dir,
        out_dir=args.out_dir,
        out_name=args.out_name,
        out_ext=args.out_ext,
        delimiter=args.delimiter,
        scoring=_scoring(args),
        strategy=args.strategy,
    )
    backend = get_backend(config, device)
    with profiler_trace(args.profile_dir, device):
        paths = run_pipeline(config, backend=backend, resume=args.resume)
    for p in paths:
        print(p)
    return 0


def _info(args) -> int:
    if args.threads > 1:
        from sparksmithwaterman_tpu_torch.metrics.threaded_refset_info import print_all_info_threaded

        print_all_info_threaded(args.ref_dir, args.out_file, args.delimiter, args.threads)
    else:
        from sparksmithwaterman_tpu_torch.metrics.refset_info import print_all_info

        print_all_info(args.ref_dir, args.out_file, args.delimiter)
    print(args.out_file)
    return 0


def _gen(args) -> int:
    from sparksmithwaterman_tpu_torch.metrics import engineer_data

    engineer_data.generate(args.out_dir, args.sweeps, scale=args.scale)
    print(args.out_dir)
    return 0


def _bench(args, device: torch.device) -> int:
    from sparksmithwaterman_tpu_torch.metrics.execution_times import run_sweeps

    print(json.dumps(run_sweeps(args.data_dir, args.out_dir, args.strategy, args.sweeps, device=device), indent=1))
    return 0


def _diff(args, device: torch.device) -> int:
    from sparksmithwaterman_tpu_torch.config import AlignConfig
    from sparksmithwaterman_tpu_torch.metrics.diff import diff_strategies

    config = AlignConfig(
        ref_dir=args.ref_dir,
        in_dir=args.in_dir,
        out_dir=args.out_dir,  # replaced per strategy inside
        delimiter=args.delimiter,
        scoring=_scoring(args),
    )
    all_equal, rows = diff_strategies(config, args.strategy_a, args.strategy_b, args.out_dir, device=device)
    for row in rows:
        print(f"{'OK ' if row['equal'] else 'DIFF'} {row['file']}")
        if row["diff"]:
            print(row["diff"], end="")
    print(
        f"{'identical' if all_equal else 'DIVERGED'}: {args.strategy_a} vs {args.strategy_b} "
        f"({len(rows)} report(s), timing line ignored)"
    )
    return 0 if all_equal else 1


def _scaling(args, device: torch.device) -> int:
    from sparksmithwaterman_tpu_torch.metrics.scaling import measure_scaling

    rows = measure_scaling(
        [int(x) for x in args.devices.split(",")] if args.devices else None,
        num_reads=args.num_reads,
        read_len=args.read_len,
        num_refs=args.num_refs,
        ref_len=args.ref_len,
        axis=args.axis,
        device=device,
    )
    print(json.dumps(rows, indent=1))
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="swtorch",
        description="Smith-Waterman alignment engine on PyTorch and CUDA",
    )
    sub = parser.add_subparsers(dest="command", required=True)
    _add_align(sub)
    _add_info(sub)
    _add_gen(sub)
    _add_bench(sub)
    _add_diff(sub)
    _add_scaling(sub)
    args = parser.parse_args(argv)

    if args.command == "info":
        return _info(args)
    if args.command == "gen":
        return _gen(args)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print(f"swtorch: device {args.device!r} requested but CUDA is not available", file=sys.stderr)
        return 2
    return {"align": _align, "bench": _bench, "diff": _diff, "scaling": _scaling}[args.command](args, device)


if __name__ == "__main__":
    sys.exit(main())
