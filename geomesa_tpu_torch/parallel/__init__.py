"""Multi-device tier: meshes, row-sharded arrays and their merges
(`parallel/mesh.py`). The multi-process runtime comes with ROADMAP A7 (c)."""

from geomesa_tpu_torch.parallel.mesh import (
    SHARD_AXIS, Mesh, Sharded, default_mesh, gather, replicated, serve_mesh,
    shard_batch_host, shard_device_batch, shard_view)

__all__ = [
    "SHARD_AXIS", "Mesh", "Sharded", "default_mesh", "gather", "replicated",
    "serve_mesh", "shard_batch_host", "shard_device_batch", "shard_view",
]
