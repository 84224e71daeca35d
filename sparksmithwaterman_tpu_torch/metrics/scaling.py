"""Multi-device strong-scaling sweep: ``swtorch scaling``.

Port of :mod:`sparksmithwaterman_tpu.metrics.scaling`.  One fixed
workload is scored on meshes of 1, 2, 4 ... devices, and each row gives
the seconds per iteration, the rate in GCUPS and the efficiency
``rate_n / (n * rate_1)``:

- ``axis='refs'``: :func:`..parallel.engine.sharded_totals` (K4 per
  block) with the reference set split over the mesh, the reference's
  DistributeReference (``src/sw/Distribution.java:227-373``); the shards
  are independent, so ideal scaling is linear;
- ``axis='seq'``: :func:`..parallel.seqparallel.seqparallel_scores`, one
  reference cut along its length, the reference's DistributeAlgorithm.

Results must agree across mesh sizes, or the sweep raises.  The devices
are every card of the host by default; ``devices=["cpu"] * n`` gives the
CPU tests a mesh of n entries.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from sparksmithwaterman_tpu_torch.io.fasta import READ_PAD, REF_PAD, encode_batch
from sparksmithwaterman_tpu_torch.parallel.engine import sharded_totals
from sparksmithwaterman_tpu_torch.parallel.mesh import build_mesh, mesh_devices
from sparksmithwaterman_tpu_torch.parallel.seqparallel import seqparallel_scores


def workload(num_reads: int, read_len: int, num_refs: int, ref_len: int):
    """(reads (R, M), refs (C, N)) uint8 of random bases from seed 0, as
    the JAX harness makes them."""
    rng = np.random.default_rng(0)
    alphabet = np.array(list("ACGT"))
    reads = ["".join(rng.choice(alphabet, size=read_len)) for _ in range(num_reads)]
    refs = ["".join(rng.choice(alphabet, size=ref_len)) for _ in range(num_refs)]
    return encode_batch(reads, read_len, READ_PAD), encode_batch(refs, ref_len, REF_PAD)


def _sweep(device_counts, devs, cells: int, iters: int, divides: int, what: str, make_run) -> List[Dict]:
    """Time ``make_run(devs[:n])()``, the workload on a mesh of n, for
    each count n; its results must be equal at every n."""
    if device_counts is None:
        device_counts = [n for n in (1, 2, 4, 8, 16, 32) if n <= len(devs)]
    rows: List[Dict] = []
    base_rate = None
    want = None
    for n in device_counts:
        if n > len(devs):
            continue
        if divides % n:
            raise ValueError(f"{what}={divides} must divide by devices={n}")
        run = make_run(devs[:n])
        out = run().cpu()  # warm up, and the parity check
        if want is None:
            want = out
        elif not torch.equal(out, want):
            raise AssertionError(f"results diverge at {n} devices")
        t0 = time.perf_counter()
        for _ in range(iters):
            r = run()
        r.cpu()  # waits for every device: the result gathers from all
        dt = (time.perf_counter() - t0) / iters
        rate = cells / dt
        if base_rate is None:
            base_rate = rate
        rows.append({
            "devices": n,
            "seconds": round(dt, 6),
            "gcups": round(rate / 1e9, 3),
            "efficiency": round(rate / (n * base_rate), 3),
        })
    return rows


def measure_scaling(
    device_counts: Optional[Sequence[int]] = None,
    *,
    num_reads: int = 32,
    read_len: int = 64,
    num_refs: int = 64,
    ref_len: int = 512,
    iters: int = 3,
    params=(5, -3, -4),
    axis: str = "refs",
    device="cuda",
    devices: Optional[Sequence] = None,
) -> List[Dict]:
    """Strong-scaling sweep over a mesh axis ('refs' or 'seq').

    ``devices``: the devices a mesh of n takes its first n from (default
    :func:`..parallel.mesh.mesh_devices` of ``device``: every card for
    'cuda').  Counts above their number are skipped; ``num_refs``
    ('refs') or ``ref_len`` ('seq') must divide by every other count.
    """
    devs = list(devices) if devices is not None else mesh_devices(device)
    params = tuple(int(v) for v in params)
    if axis == "seq":
        reads_enc, refs_enc = workload(num_reads, read_len, 1, ref_len)

        def seq_run(d):
            mesh = build_mesh((len(d),), axis_names=("seq",), devices=d)
            return lambda: seqparallel_scores(reads_enc, refs_enc[0], *params, mesh=mesh)

        return _sweep(device_counts, devs, num_reads * read_len * ref_len, iters, ref_len, "ref_len", seq_run)
    if axis != "refs":
        raise ValueError(f"axis must be 'refs' or 'seq', got {axis!r}")
    reads_enc, refs_enc = workload(num_reads, read_len, num_refs, ref_len)

    def refs_run(d):
        mesh = build_mesh((len(d), 1), devices=d)
        return lambda: sharded_totals(reads_enc, refs_enc, *params, mesh=mesh)

    cells = num_reads * read_len * num_refs * ref_len
    return _sweep(device_counts, devs, cells, iters, num_refs, "num_refs", refs_run)
