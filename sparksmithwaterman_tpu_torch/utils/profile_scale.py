"""Where the time goes in the scale or long-reference workload, on one
CUDA card.

    python -m sparksmithwaterman_tpu_torch.utils.profile_scale [--out FILE] [--corpus-bp N]
    python -m sparksmithwaterman_tpu_torch.utils.profile_scale --workload long_ref --strategy shard_seq
    python -m sparksmithwaterman_tpu_torch.utils.profile_scale --no-pack-reads
    python -m sparksmithwaterman_tpu_torch.utils.profile_scale --long-refs 0

Builds the workload (``scale``: ``metrics.engineer_data.scale_corpus``, a
RefSeq-shaped corpus plus ``--long-refs`` references of 131,072 bp
(default 8), 512 reads; ``long_ref``: ``long_ref_corpus``, references of
8 kb-1 Mb, 256 reads),
runs ``run_pipeline`` with the strategy's backend once to build and warm
up, twice timed, then once under ``torch.profiler`` with the pipeline's
layers wrapped in named spans.  ``--no-pack-reads`` sets the config's
``pack_reads=False``: the batch backend then scores through the unpacked
path (K4).  With ``--long-refs 0`` the scale workload's winner is a
RefSeq-shaped reference of a few kb, which takes the full-fill traceback
(``L3c``) where the 131 kb winner takes the windowed one (``L3b``).

- ``L1.parse``: reference-file parsing;
- ``L2.score_flush``: one scoring flush on the host (encode, upload,
  kernel dispatches, gather-sums); ``L2.encode_refs`` its reference
  encoding, ``L2a.K1`` its K1 calls, ``L2b.K3`` its K3 calls; on the
  unpacked path ``L2.encode_grid`` its read and reference encoding
  (padded batches; the full-fill traceback's encoding counts here too),
  ``L2.stage_grid`` its uploads and ``L2c.K4`` its K4 (or K5) calls;
- ``L3.traceback``: one winner's traceback; ``L3a.max_cells`` (K2 and the
  in-lane-tie listing), ``L3b.window_fill_walk`` and ``L3c.full_fill``
  its parts; ``L3a.K2`` its K2 call (``argmax_lane``) and ``L3a.K8`` the
  listing's K8 calls (``max_cells_row``);
  ``L3b.fill_walk`` the window dispatches' calls of K9 and K10 in one
  launch (``fill_walk``) and ``L3c.fill_list`` the full fills' (``fill_list``);
  in a tree before those (PRs 12-14), ``L3b.K9`` and ``L3b.K10`` the window
  fills' K9 calls (``fill_dirs``) and walks' K10 calls (``trace_walk``),
  ``L3c.K9`` and ``L3c.K10`` the full fills' and their walks'.

A span's time is its wall time on the host (nested spans count inside
their parents).  Device time is summed per kernel or copy, over device
events only: summing spans or ``aten`` operators too would count each
kernel again.  The idle share is 1 - busy / wall of the profiled pass.
The span wrappers exist only in this script, and a function the
package does not have is not wrapped (so the script also profiles an
older tree put first on ``PYTHONPATH``); with ``--out`` the summary
and the full operator table are also written to that file.
"""

from __future__ import annotations

import argparse
import collections
import functools
import os
import sys
import tempfile
import time


def _wrap(owner, name: str, span: str) -> None:
    from torch.profiler import record_function

    fn = getattr(owner, name)

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with record_function(span):
            return fn(*args, **kwargs)

    setattr(owner, name, wrapped)


SPANS = {
    "L1.parse": ("pipeline", "get_ref_seqs"),
    "L2.score_flush": ("backend", "_totals_dev"),
    "L2.encode_refs": ("batch_backend", "encode_concat"),
    "L2a.K1": ("batch_backend", "lane_best_packed_varlen"),
    "L2b.K3": ("seqparallel", "band_lane_best"),
    "L2.encode_grid": ("batch_backend", "encode_batch"),
    "L2.stage_grid": ("backend", "_stage"),
    "L2c.K4": ("batch_backend", "_score_grid"),
    "L3.traceback": ("backend", "sites_for_ref"),
    "L3a.max_cells": ("batch_backend", "find_max_cells_batched"),
    "L3a.K2": ("longseq", "argmax_lane"),
    "L3a.K8": ("longseq", "max_cells_row"),
    "L3b.window_fill_walk": ("batch_backend", "sites_for_ref_long_batched"),
    "L3b.fill_walk": ("longseq", "fill_walk"),
    "L3b.K9": ("longseq", "fill_dirs"),
    "L3b.K10": ("longseq", "trace_walk"),
    "L3c.full_fill": ("backend", "_sites_full_fill"),
    "L3c.fill_list": ("device_traceback", "fill_list"),
    "L3c.K9": ("device_traceback", "fill_dirs"),
    "L3c.K10": ("device_traceback", "trace_walk"),
}


def _instrument(backend_cls) -> None:
    from sparksmithwaterman_tpu_torch.models import batch_backend, pipeline
    from sparksmithwaterman_tpu_torch.ops import device_traceback, longseq
    from sparksmithwaterman_tpu_torch.parallel import seqparallel

    owners = {"pipeline": pipeline, "batch_backend": batch_backend, "seqparallel": seqparallel, "longseq": longseq,
              "device_traceback": device_traceback, "backend": backend_cls}
    for span, (owner, name) in SPANS.items():
        if hasattr(owners[owner], name):
            _wrap(owners[owner], name, span)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", default=None, help="also write the summary and operator table here")
    parser.add_argument("--workload", choices=["scale", "long_ref"], default="scale")
    parser.add_argument("--strategy", choices=["batch", "shard_seq"], default="batch")
    parser.add_argument("--corpus-bp", type=int, default=None, help="default 64 Mbp (scale), 16 Mbp (long_ref)")
    parser.add_argument("--long-refs", type=int, default=8, help="scale workload: references of 131,072 bp")
    parser.add_argument("--seed", type=int, default=20261016)
    parser.add_argument("--no-pack-reads", dest="pack_reads", action="store_false",
                        help="AlignConfig(pack_reads=False): score through the unpacked path (K4)")
    args = parser.parse_args(argv)

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from sparksmithwaterman_tpu_torch.config import AlignConfig
    from sparksmithwaterman_tpu_torch.metrics.engineer_data import long_ref_corpus, scale_corpus
    from sparksmithwaterman_tpu_torch.models.aligner import get_backend
    from sparksmithwaterman_tpu_torch.models.pipeline import run_pipeline

    if not torch.cuda.is_available():
        print("profile_scale: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    with tempfile.TemporaryDirectory(prefix="swtorch_profile_") as work:
        if args.workload == "scale":
            corpus = scale_corpus(work, corpus_bp=args.corpus_bp or 64_000_000, long_refs=args.long_refs,
                                  seed=args.seed)
        else:
            corpus = long_ref_corpus(work, args.corpus_bp or 16_000_000, seed=args.seed)
        cells = corpus["ref_bp"] * corpus["read_bp"]
        config = AlignConfig(
            ref_dir=os.path.join(work, "refs"),
            in_dir=os.path.join(work, "inputs"),
            out_dir=os.path.join(work, "out"),
            strategy=args.strategy,
            pack_reads=args.pack_reads,
        )
        backend = get_backend(config, dev)

        def run() -> float:
            torch.cuda.synchronize()
            t = time.perf_counter()
            run_pipeline(config, backend=backend, device=dev)
            torch.cuda.synchronize()
            return time.perf_counter() - t

        walls = [run() for _ in range(3)]  # first: build and warm-up
        _instrument(type(backend))
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            wall = run()

    host = collections.defaultdict(lambda: [0, 0.0])  # span -> [calls, host us]
    kernels = collections.defaultdict(float)  # device event -> device us
    for e in prof.events():
        if e.device_type == DeviceType.CPU and e.name in SPANS:
            host[e.name][0] += 1
            host[e.name][1] += e.time_range.elapsed_us()
        elif e.device_type == DeviceType.CUDA and e.name not in SPANS:
            kernels[e.name] += e.time_range.elapsed_us()
    busy = sum(kernels.values()) / 1e6
    lines = [
        f"profile_scale: {args.workload} workload, {args.strategy}, pack_reads={args.pack_reads}, "
        f"long_refs={args.long_refs if args.workload == 'scale' else 0}, "
        f"{torch.cuda.get_device_name(0)}: "
        f"{corpus['read_bp']} read bp x {corpus['ref_bp']} ref bp",
        "walls s (the first builds and warms up): " + ", ".join(f"{w:.3f}" for w in walls)
        + "; real GCUPS of the warm ones: " + ", ".join(f"{cells / w / 1e9:.1f}" for w in walls[1:]),
        f"profiled pass: wall {wall:.3f} s, device busy {busy:.3f} s, idle share {1 - busy / wall:.3f}",
        "host spans:",
        *(f"  {name:<22} calls {host[name][0]:>5}  {host[name][1] / 1e6:8.3f} s" for name in SPANS if name in host),
        "device time by kernel or copy:",
        *(f"  {us / 1e6:8.3f} s  {name[:110]}" for name, us in sorted(kernels.items(), key=lambda kv: -kv[1])[:15]),
    ]
    print("\n".join(lines))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write("\n".join(lines) + "\n\n" + prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=40))
        print(f"operator table: {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
