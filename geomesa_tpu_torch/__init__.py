"""geomesa_tpu_torch: the PyTorch/CUDA port of geomesa_tpu for NVIDIA Hopper.

The JAX package `geomesa_tpu` beside it is the reference this package is
tested against; this package imports nothing of it (nor JAX). It covers
the north-star chain (a BBOX+time+attribute CQL filter over the Parquet
filesystem DataStore, device-resident partitions, and the fused kNN scan
whose block-minima kernels are hand-written CUDA,
`engine/kernels/chord_blockmin.cu`), density heatmaps through
`get_features` and `process.DensityProcess` (the cell-dictionary kernel,
`engine/kernels/density_zsparse.cu`), and polygon filters on point
columns (the crossing-number kernel and its band,
`engine/kernels/pip_crossing.cu`), the polygon-layer join, feature
results, TubeSelect, and `process.KNearestNeighborSearchProcess` on every
route, with the write-path stats sketches (`stats/`) that resolve its
default `impl="auto"`, and the serve stack's host half (`serve/`:
`QueryService` futures with coalesced kNN windows, deadlines and the
JSON-lines wire, on the serial, pipelined and ring routes), the storage
lifecycle (deletes, age-off, compaction, ORC) under the fault fabric
(`faults/`), converters (`convert/`), ingest/export jobs (`jobs.py`) and
the Arrow IPC store (`store/arrow_store.py`), the key-value index store
(`index/`), the live layer (`kafka/`) and the lambda store
(`lambda_store.py`). Entry points run on the card unless the caller
passes device="cpu".
"""

from geomesa_tpu_torch.core.columnar import FeatureBatch
from geomesa_tpu_torch.core.sft import SimpleFeatureType
from geomesa_tpu_torch.errors import CudaUnavailableError, NotPortedError
from geomesa_tpu_torch.plan import DataStore, FeatureSource, Query, QueryHints

__all__ = [
    "CudaUnavailableError", "DataStore", "FeatureBatch", "FeatureSource",
    "NotPortedError", "Query", "QueryHints", "SimpleFeatureType",
]
