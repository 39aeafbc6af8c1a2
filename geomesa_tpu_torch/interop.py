"""State carried across from the reference package.

The reference's device batch is a dict of JAX arrays; pass each through
`np.asarray` and hand the dict here to get the port's device batch with
the same keys and dtypes (a polygon layer's CSR and edge-table keys
included). Likewise its `GridIndex` (each field through `np.asarray`, the
grid edge as it is) becomes the port's, and its host `FeatureBatch` (a
polygon layer's CSR geometry column included) becomes the port's through
`feature_batch_from`, read by attribute, so nothing of the reference is
imported. Catalogs on disk need no conversion: both packages read and
write the same format under every partition scheme, WKT geometry columns
and the stats sketches' `stats.json` included, and so does the
approximate tier's sketch sidecar (`<store>/.approx_sketches.json`,
`approx/sketches.py`): a sidecar either package wrote is loaded by the
other with no partition rebuild and answers the same approximate counts
and bounds. The device cache's manifest records the coordinate dtype
(`geomesa.coord.dtype`) as the reference's does.
"""

from __future__ import annotations

from typing import Dict, Union

import numpy as np
import torch

from geomesa_tpu_torch.core.columnar import DictColumn, FeatureBatch, GeometryColumn
from geomesa_tpu_torch.core.sft import SimpleFeatureType
from geomesa_tpu_torch.engine.device import DeviceBatch, resolve_device
from geomesa_tpu_torch.engine.grid_index import GridIndex


def device_batch_from_numpy(arrays: Dict[str, np.ndarray],
                            device: Union[str, torch.device, None] = None
                            ) -> DeviceBatch:
    """{key: host array} -> {key: tensor on `device`}, dtypes preserved."""
    dev = resolve_device(device)
    # copied: the reference's arrays come back read-only
    return {k: torch.from_numpy(np.array(v, copy=True)).to(dev)
            for k, v in arrays.items()}


def grid_index_from_numpy(sx, sy, sidx, starts, counts, g: int,
                          device: Union[str, torch.device, None] = None
                          ) -> GridIndex:
    """The reference's GridIndex fields (host arrays) -> the port's
    GridIndex on `device`, dtypes preserved."""
    dev = resolve_device(device)
    t = [torch.from_numpy(np.array(a, copy=True)).to(dev)
         for a in (sx, sy, sidx, starts, counts)]
    return GridIndex(*t, g=int(g))


def _column_from(col):
    if hasattr(col, "vocab"):
        return DictColumn(np.array(col.codes, np.int32), list(col.vocab))
    if hasattr(col, "ring_offsets"):
        def copy(a, dtype=None):
            return None if a is None else np.array(a, dtype=dtype)

        return GeometryColumn(
            col.kind, copy(col.x, np.float64), copy(col.y, np.float64),
            copy(col.vertices, np.float64), copy(col.ring_offsets, np.int64),
            copy(col.feature_rings, np.int64),
            (None if col.feature_parts is None
             else [list(p) for p in col.feature_parts]),
            copy(col.bbox, np.float64), copy(col.feature_kinds, np.int8))
    return np.array(col, copy=True)


def feature_batch_from(batch) -> FeatureBatch:
    """A reference host FeatureBatch (schema, columns, fids, validity) ->
    the port's, its arrays copied."""
    sft = SimpleFeatureType.from_spec(batch.sft.name, batch.sft.to_spec())
    cols = {name: _column_from(c) for name, c in batch.columns.items()}
    fids = None if batch.fids is None else _column_from(batch.fids)
    valid = None if batch.valid is None else np.array(batch.valid, bool)
    return FeatureBatch(sft, cols, fids, valid)
