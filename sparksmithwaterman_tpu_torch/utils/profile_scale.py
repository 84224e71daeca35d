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
up, twice timed, then once with the port's own tracer on
(``utils.profiling``).  ``--no-pack-reads`` sets the config's
``pack_reads=False``: the batch backend then scores through the unpacked
path (K4).  With ``--long-refs 0`` the scale workload's winner is a
RefSeq-shaped reference of a few kb, which takes the full-fill traceback
(``traceback:full``) where the 131 kb winner takes the windowed one
(``traceback:windowed``).

It prints, for the traced pass:

- host spans: for each of the program's span labels (``file``, ``parse``,
  ``flush``, ``encode``, ``wait:throttle``, ``wait:upload``,
  ``wait:resolve``, ``wait:readback``, ``traceback:windowed``,
  ``traceback:full``, ``report``) its calls, its wall time (nested spans
  count inside their parents) and its self time (less its children's);
- device time by C entry of the kernel library: each launch from its
  first timing event to its second, placed on the host clock through the
  tracer's anchors (an event pair holds the launch and any wait of its
  stream); copies and PyTorch's own kernels are not in it;
- device time by the span each launch was made in (``flush`` for K1,
  ``traceback:*`` for K2, K8 and the fills);
- the idle share, 1 - the union of the launches / the wall of the pass,
  and the anchors' drift.

Nothing is wrapped from outside, and every record is kept: an event pair
per launch, read once the card is synchronised.  With ``--out`` the
summary is also written to that file.
"""

from __future__ import annotations

import argparse
import collections
import os
import sys
import tempfile
import time


def summary(rec, wall: float) -> list:
    """Lines of the host spans, the device time by C entry and by span,
    and the idle share of a pass of ``wall`` seconds from ``rec``
    (``profiling.Records``)."""
    from sparksmithwaterman_tpu_torch.utils.profiling import self_pieces

    host = collections.defaultdict(lambda: [0, 0.0, 0.0])  # label -> [calls, wall s, self s]
    for s in rec.spans:
        host[s.label][0] += 1
        host[s.label][1] += s.end - s.start
    for a, b, s in self_pieces(rec.spans):
        host[s.label][2] += b - a
    by_entry = collections.defaultdict(lambda: [0, 0.0])
    by_span = collections.defaultdict(float)
    for x in rec.launches:
        by_entry[x.entry][0] += 1
        by_entry[x.entry][1] += x.end - x.start
        by_span[x.span.label if x.span else "(no span)"] += x.end - x.start
    busy = 0.0
    for device in {x.device for x in rec.launches}:
        end = -float("inf")
        for a, b in sorted((x.start, x.end) for x in rec.launches if x.device == device):
            busy += max(0.0, b - max(a, end))
            end = max(end, b)
    cards = max(1, len({x.device for x in rec.launches}))
    return [
        f"traced pass: wall {wall:.3f} s, device busy {busy / cards:.3f} s a card, "
        f"idle share {1 - busy / cards / wall:.3f}; anchors' drift "
        + ", ".join(f"card {d} {v * 1e3:+.4f} ms" for d, v in sorted(rec.drift.items())),
        "host spans (calls, wall s, self s):",
        *(f"  {label:<22} calls {c:>5}  {w:8.3f}  {own:8.3f}"
          for label, (c, w, own) in sorted(host.items(), key=lambda e: -e[1][1])),
        "device time by C entry (launches, s):",
        *(f"  {name:<36} {n:>5}  {t:8.3f}" for name, (n, t) in sorted(by_entry.items(), key=lambda e: -e[1][1])),
        "device time by the span its launches were made in (s):",
        *(f"  {label:<22} {t:8.3f}" for label, t in sorted(by_span.items(), key=lambda e: -e[1])),
    ]


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

    from sparksmithwaterman_tpu_torch.config import AlignConfig
    from sparksmithwaterman_tpu_torch.metrics.engineer_data import long_ref_corpus, scale_corpus
    from sparksmithwaterman_tpu_torch.models.aligner import get_backend
    from sparksmithwaterman_tpu_torch.models.pipeline import run_pipeline
    from sparksmithwaterman_tpu_torch.utils import profiling

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

        walls = [run() for _ in range(3)]  # first: build and warm up
        profiling.reset()
        profiling.enable()
        try:
            wall = run()
            rec = profiling.records()
        finally:
            profiling.disable()

    lines = [
        f"profile_scale: {args.workload} workload, {args.strategy}, pack_reads={args.pack_reads}, "
        f"long_refs={args.long_refs if args.workload == 'scale' else 0}, "
        f"{torch.cuda.get_device_name(0)}: "
        f"{corpus['read_bp']} read bp x {corpus['ref_bp']} ref bp",
        "walls s (the first builds and warms up): " + ", ".join(f"{w:.3f}" for w in walls)
        + "; real GCUPS of the warm ones: " + ", ".join(f"{cells / w / 1e9:.1f}" for w in walls[1:]),
        *summary(rec, wall),
    ]
    print("\n".join(lines))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write("\n".join(lines) + "\n")
        print(f"summary: {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
