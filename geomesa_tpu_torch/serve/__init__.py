"""Concurrent query serving: admission control, request coalescing,
deadlines, pipelined dispatch, the persistent ring and the JSON-lines
wire.

The port of the reference package's `serve/`: `QueryService` futures
over a DataStore (`service.py`), admission and deadlines
(`scheduler.py`), coalescing (`batcher.py`: N concurrent kNN requests
with one (filter, k) stack into ONE launch of B1 or B2), the pipelined
dispatch on CUDA streams and events (`pipeline.py`), the ring of
captured CUDA graphs (`ringloop.py`), the JSON-lines wire
(`protocol.serve_lines`, `protocol.serve_connection`) with its columnar
framing and codecs (`columnar.py`), and the closed-loop, open-loop and
sustained load generators (`loadgen.py`). Sharded serving over a device
mesh (`ServeConfig.mesh`) runs on the serial, pipelined and ring routes;
the multi-process runtime comes with A7 (c).
"""

from geomesa_tpu_torch.serve.scheduler import (
    PRIORITIES, AdmissionQueue, QueryRejected, RateLimiter, ServeRequest,
    TokenBucket)
from geomesa_tpu_torch.serve.batcher import compat_key, execute_batch
from geomesa_tpu_torch.serve.service import QueryService, ServeConfig, self_check
from geomesa_tpu_torch.serve.protocol import serve_connection, serve_lines
from geomesa_tpu_torch.serve.loadgen import (
    LoadReport, count_request_factory, knn_request_factory,
    run_closed_loop, run_open_loop, run_sustained)

__all__ = [
    "PRIORITIES", "AdmissionQueue", "QueryRejected", "RateLimiter",
    "ServeRequest", "TokenBucket", "compat_key", "execute_batch",
    "QueryService", "ServeConfig", "self_check",
    "serve_connection", "serve_lines", "LoadReport",
    "knn_request_factory", "count_request_factory",
    "run_closed_loop", "run_open_loop", "run_sustained",
]
