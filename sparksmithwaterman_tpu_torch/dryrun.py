"""Multi-chip dry run: one sharded step on an n-entry mesh.

The counterpart of the JAX package's ``__graft_entry__.dryrun_multichip``:
``n_devices`` factored into a (refs, reads) :class:`DeviceMesh` (2, else
3, entries on the reads axis), one :func:`sharded_totals` and one
:func:`sharded_score_grid` call on seeded inputs, the grid's column sums
held to the totals and both to the unsharded plain result (K4's plain
version on the CPU).  The mesh's entries cycle over the devices of
``device`` (``parallel.mesh.mesh_devices``), so one card, or the CPU,
fills every entry when there is only one.
"""

from __future__ import annotations

import numpy as np
import torch

from sparksmithwaterman_tpu_torch.ops.cuda_score import score_grid_diag_plain
from sparksmithwaterman_tpu_torch.parallel.engine import sharded_score_grid, sharded_totals
from sparksmithwaterman_tpu_torch.parallel.mesh import build_mesh, mesh_devices

_PARAMS = (5, -3, -4)


def dryrun_multichip(n_devices: int, device="cuda") -> dict:
    """Run the sharded step on an ``n_devices``-entry mesh of ``device``'s
    devices; raise ``RuntimeError`` on any mismatch.  Returns the mesh's
    shape, its entries and the inputs' shapes."""
    reads_ax = next((cand for cand in (2, 3) if n_devices % cand == 0), 1)
    devs = mesh_devices(device)
    mesh = build_mesh((n_devices // reads_ax, reads_ax), devices=[devs[i % len(devs)] for i in range(n_devices)])

    rng = np.random.default_rng(0)
    r = 8 * mesh.shape["reads"]
    c = 2 * mesh.shape["refs"]
    reads = rng.integers(2, 6, size=(r, 16)).astype(np.uint8)
    refs = rng.integers(2, 6, size=(c, 32)).astype(np.uint8)

    totals = sharded_totals(reads, refs, *_PARAMS, mesh=mesh).cpu()
    grid = sharded_score_grid(reads, refs, *_PARAMS, mesh=mesh).cpu()
    plain = score_grid_diag_plain(torch.from_numpy(reads), torch.from_numpy(refs), *_PARAMS)
    if not torch.equal(grid.sum(dim=0, dtype=torch.int64), totals):
        raise RuntimeError(f"dry run on {mesh.shape}: the grid's column sums differ from sharded_totals")
    if not torch.equal(grid, plain):
        raise RuntimeError(f"dry run on {mesh.shape}: sharded_score_grid differs from the unsharded plain grid")
    if not torch.equal(totals, plain.sum(dim=0, dtype=torch.int64)):
        raise RuntimeError(f"dry run on {mesh.shape}: sharded_totals differ from the unsharded plain totals")
    return {"mesh": mesh.shape, "devices": [str(d) for d in mesh.devices.reshape(-1)], "reads": (r, 16), "refs": (c, 32)}
