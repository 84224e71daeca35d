"""Packed step variants A-E at one shape: what the start-lane mask costs.

    python -m sparksmithwaterman_tpu_torch.experiments.packed_step_variants [--n N] [--device cuda]

Counterpart of the JAX package's ``experiments/packed_step_variants.py``,
through K7 (:func:`..ops.cuda_score.step_variant_best`): A masks start
lanes with a select (the packed kernels' step), B masks lane 0 only, C
multiplies by "not a start", D does not mask, E is A without the
segmented suffix max.  B and D give wrong scores on purpose.  The JAX
script cannot run E (its step has no branch for it); here E runs as
its comment meant it.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from sparksmithwaterman_tpu_torch.io.fasta import REF_PAD, encode_batch
from sparksmithwaterman_tpu_torch.ops import cuda_score
from sparksmithwaterman_tpu_torch.ops.microbench import seconds_per_call
from sparksmithwaterman_tpu_torch.ops.packing import START_BIT

M, MM, G = 5, -3, -4


def run(variant, rows=248, m=256, c=64, n=1024, iters=8, unroll=16, device="cuda"):
    """Time K7 in one variant on the JAX script's inputs; print its line
    and return the seconds per call."""
    rng = np.random.default_rng(0)
    packed = rng.integers(65, 85, size=(rows, m)).astype(np.int32)
    packed[:, 0] |= START_BIT
    refs = ["".join(rng.choice(np.array(list("ACGT")), size=n)) for _ in range(c)]
    packed_t = torch.from_numpy(packed).to(device)
    refs_t = torch.from_numpy(encode_batch(refs, n, REF_PAD)).to(device)

    dt = seconds_per_call(
        lambda: cuda_score.step_variant_best(packed_t, refs_t, variant=variant, unroll=unroll, match=M, mismatch=MM,
                                             gap=G),
        iters, device,
    )
    cells = rows * m * c * n
    print(f"variant {variant} u={unroll}: {dt*1000:.1f}ms padded={cells/dt/1e9:.0f} G/s")
    return dt


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--n", type=int, default=1024, help="reference length (default 1024)")
    parser.add_argument("--iters", type=int, default=8)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        print("packed_step_variants: CUDA is not available", file=sys.stderr)
        return 2
    for v in cuda_score.STEP_VARIANTS:
        run(v, n=args.n, iters=args.iters, device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
