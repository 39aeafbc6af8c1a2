"""DensityProcess.

Parity: geomesa-process analytic/DensityProcess [upstream, unverified],
as the reference package's `process/density.py` models it: a heatmap of
matching features through the density hint of `get_features`, with the
radiusPixels gaussian spread. Returns the (height, width) f32 grid
(row 0 = south; callers flip for raster rendering).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from geomesa_tpu_torch.engine.density import gaussian_blur
from geomesa_tpu_torch.plan.datastore import FeatureSource
from geomesa_tpu_torch.plan.hints import QueryHints
from geomesa_tpu_torch.plan.query import Query


class DensityProcess:
    name = "DensityProcess"

    def execute(
        self,
        data: FeatureSource,
        bbox: Tuple[float, float, float, float],
        width: int = 512,
        height: int = 512,
        cql_filter: str = "INCLUDE",
        weight_attr: Optional[str] = None,
        radius_pixels: int = 0,
    ) -> np.ndarray:
        q = Query(
            data.sft.name,
            cql_filter,
            hints=QueryHints(
                density_bbox=tuple(bbox),
                density_width=width,
                density_height=height,
                density_weight=weight_attr,
            ),
        )
        grid = data.get_features(q).grid
        if radius_pixels > 0:
            # the spread runs where the query ran: on the source's device
            dev = data.planner.device
            grid = gaussian_blur(torch.from_numpy(grid).to(dev),
                                 radius_pixels).cpu().numpy()
        return grid
