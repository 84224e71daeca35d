"""Time-packing probe: what a moving reference boundary costs per step.

    python -m sparksmithwaterman_tpu_torch.experiments.triangle_timepack [--steps N] [--device cuda]

Counterpart of the JAX package's ``experiments/triangle_timepack.py``.
Chaining references along the diagonal axis of one row pays the m - 1
diagonal ramp once per chain instead of once per reference, but every
step must then zero the lanes whose diagonal has left the current
reference.  This script times the step chain of K6
(:func:`..ops.cuda_score.step_chain_best`) without and with that mask
(``masked=True``), at the read-scale shape (rb=248, m=256) and the fold
shape (rb=256, m=256).  The mask pays only if its tax is below the
triangle's geometric factor (m + n - 1) / n, 1.128 at the JAX bench's
e2e geometry.
"""

from __future__ import annotations

import argparse
import sys

import torch

from sparksmithwaterman_tpu_torch.ops.microbench import step_roofline

TRIANGLE_GAIN = 1.128


def rate(rb, m, masked, steps=131_072, unroll=64, iters=20, device="cuda"):
    """Padded GCUPS of the step chain with scores 5/-3/-4."""
    return step_roofline(rb, m, steps=steps, iters=iters, unroll=unroll, params=(5, -3, -4), masked=masked,
                         device=device)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--steps", type=int, default=131_072)
    parser.add_argument("--iters", type=int, default=20)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        print("triangle_timepack: CUDA is not available", file=sys.stderr)
        return 2
    for rb, m in ((248, 256), (256, 256)):
        plain = rate(rb, m, False, steps=args.steps, iters=args.iters, device=args.device)
        taxed = rate(rb, m, True, steps=args.steps, iters=args.iters, device=args.device)
        tax = plain / taxed
        print(
            f"rb={rb} m={m}: plain {plain:.1f} GCUPS | "
            f"masked {taxed:.1f} GCUPS | tax {tax:.3f}x "
            f"(triangle gain at e2e geometry: {TRIANGLE_GAIN}x -> "
            f"{'WIN' if tax < TRIANGLE_GAIN else 'DEAD END'})"
        )
    return 0


if __name__ == "__main__":
    sys.exit(main())
