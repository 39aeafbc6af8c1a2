"""State carried across from the reference package.

The reference's device batch is a dict of JAX arrays; pass each through
`np.asarray` and hand the dict here to get the port's device batch with
the same keys and dtypes. Likewise its `GridIndex` (each field through
`np.asarray`, the grid edge as it is) becomes the port's. Catalogs on
disk need no conversion: both packages read and write the same format,
the stats sketches' `stats.json` included.
"""

from __future__ import annotations

from typing import Dict, Union

import numpy as np
import torch

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
