"""Multi-device parallelism of the port: device meshes and the three mesh
strategies.

Port of :mod:`sparksmithwaterman_tpu.parallel`: a :class:`DeviceMesh` of
torch devices in place of a ``jax.sharding.Mesh``, and device-to-device
copies in place of ``shard_map`` collectives.
"""

from sparksmithwaterman_tpu_torch.parallel.engine import ShardedBackend, sharded_score_grid, sharded_totals
from sparksmithwaterman_tpu_torch.parallel.mesh import DeviceMesh, build_mesh, mesh_devices
from sparksmithwaterman_tpu_torch.parallel.seqparallel import SeqParallelBackend, seqparallel_scores

__all__ = [
    "DeviceMesh",
    "build_mesh",
    "mesh_devices",
    "ShardedBackend",
    "sharded_score_grid",
    "sharded_totals",
    "SeqParallelBackend",
    "seqparallel_scores",
]
