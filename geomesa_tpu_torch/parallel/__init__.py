"""Multi-device and multi-process tier: meshes, row-sharded arrays and
their merges (`parallel/mesh.py`), and the process group that lets one
mesh span processes (`parallel/distributed.py`, `parallel/launch.py`)."""

from geomesa_tpu_torch.parallel.distributed import (
    global_mesh, initialize, is_coordinator, process_suffix)
from geomesa_tpu_torch.parallel.mesh import (
    SHARD_AXIS, Mesh, Sharded, default_mesh, gather, replicated, serve_mesh,
    shard_batch_host, shard_device_batch, shard_view)

__all__ = [
    "SHARD_AXIS", "Mesh", "Sharded", "default_mesh", "gather",
    "global_mesh", "initialize", "is_coordinator", "process_suffix",
    "replicated", "serve_mesh", "shard_batch_host", "shard_device_batch",
    "shard_view",
]
