"""Device meshes of the port.

Port of :mod:`sparksmithwaterman_tpu.parallel.mesh`.  A
:class:`DeviceMesh` is an array of ``torch.device`` entries with named
axes, the counterpart of ``jax.sharding.Mesh``:

- ``'refs'``  — shards of the reference set (the reference's
  DistributeReference, ``src/sw/Distribution.java:227-373``);
- ``'reads'`` — shards of the read batch (its declared DistributeReads,
  ``src/sw/Distribution.java:440-468``);
- ``'seq'``   — segments of one reference (its DistributeAlgorithm,
  ``src/sw/DistributedSW.java:118-252``).

One process drives every card of its host, as the JAX single-controller
mesh does; nothing here uses ``torch.distributed``.  An entry may be the
CPU, and one device may fill several entries: that is how the CPU tests
get the JAX tests' eight virtual devices, and how one card runs several
segments.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch


def _normalize(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


class DeviceMesh:
    """An n-D array of torch devices with one name per axis."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
        self.devices = devices
        self.axis_names = tuple(axis_names)
        if devices.ndim != len(self.axis_names):
            raise ValueError(f"{devices.ndim}-D device array with axis names {self.axis_names}")

    @property
    def shape(self) -> Dict[str, int]:
        """Entries along each axis, by name (as ``jax.sharding.Mesh.shape``)."""
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)


def mesh_devices(device="cuda") -> list:
    """The devices of this process's default mesh: for ``device="cuda"``
    every card (``torch.cuda.device_count()``, as ``jax.local_devices()``);
    for a device with an index, or the CPU, that one device."""
    device = torch.device(device)
    if device.type != "cuda" or device.index is not None:
        return [_normalize(device)]
    count = torch.cuda.device_count()
    if count == 0:
        raise RuntimeError("no CUDA device: name the mesh's devices (devices=[...]) to run elsewhere")
    return [torch.device("cuda", i) for i in range(count)]


def build_mesh(
    axis_shape: Optional[Sequence[int]] = None,
    axis_names: Sequence[str] = ("refs", "reads"),
    devices: Optional[Sequence] = None,
) -> DeviceMesh:
    """Build a mesh over ``devices`` (default: :func:`mesh_devices`).

    Default shape: every entry on the first axis, size 1 on the others —
    reference-set sharding first, the strategy the reference found
    effective (its ``README.md:145-191``).
    """
    devs = [_normalize(d) for d in devices] if devices is not None else mesh_devices()
    if axis_shape is None:
        axis_shape = (len(devs),) + (1,) * (len(axis_names) - 1)
    if int(np.prod(axis_shape)) != len(devs):
        raise ValueError(f"axis_shape {tuple(axis_shape)} != {len(devs)} devices")
    arr = np.empty(len(devs), dtype=object)
    arr[:] = devs
    return DeviceMesh(arr.reshape(tuple(axis_shape)), axis_names)


def split_by_bp(lens: np.ndarray, parts: int) -> List[np.ndarray]:
    """Indices of ``lens`` in ``parts`` groups of near-equal base pairs:
    longest first, each to the group with the fewest so far (ties to the
    lowest group).  Each group lists its references longest first; groups
    may be empty."""
    load = np.zeros(parts, np.int64)
    groups: List[List[int]] = [[] for _ in range(parts)]
    for i in np.argsort(-np.asarray(lens), kind="stable"):
        g = int(np.argmin(load))
        groups[g].append(int(i))
        load[g] += max(1, int(lens[i]))
    return [np.asarray(g, dtype=np.int64) for g in groups]
