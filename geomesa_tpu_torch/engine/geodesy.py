"""Geodetic distance: haversine on the WGS84 mean sphere.

The counterpart of the reference package's `engine/geodesy.py`:
`haversine_m` on torch tensors (f32 or f64, the inputs' dtype) and the
NumPy f64 `haversine_m_np`, the oracle distance every route reports.
"""

from __future__ import annotations

import numpy as np
import torch

EARTH_RADIUS_M = 6_371_008.8  # IUGG mean radius


def haversine_m(lon1, lat1, lon2, lat2, dtype=None) -> torch.Tensor:
    """Great-circle distance in meters; broadcasts over inputs. Computes
    in the inputs' dtype (or `dtype`), with the reference's formula."""
    if dtype is not None:
        lon1, lat1, lon2, lat2 = (torch.as_tensor(a, dtype=dtype)
                                  for a in (lon1, lat1, lon2, lat2))
    rlon1, rlat1, rlon2, rlat2 = (torch.deg2rad(a)
                                  for a in (lon1, lat1, lon2, lat2))
    dlat = rlat2 - rlat1
    dlon = rlon2 - rlon1
    a = (
        torch.sin(dlat / 2) ** 2
        + torch.cos(rlat1) * torch.cos(rlat2) * torch.sin(dlon / 2) ** 2
    )
    return 2.0 * EARTH_RADIUS_M * torch.asin(torch.sqrt(torch.clamp(a, 0.0, 1.0)))


def haversine_m_np(lon1, lat1, lon2, lat2):
    """NumPy f64 reference implementation (the oracle's distance)."""
    rlon1, rlat1, rlon2, rlat2 = (
        np.radians(np.asarray(a, np.float64)) for a in (lon1, lat1, lon2, lat2)
    )
    dlat = rlat2 - rlat1
    dlon = rlon2 - rlon1
    a = (
        np.sin(dlat / 2) ** 2
        + np.cos(rlat1) * np.cos(rlat2) * np.sin(dlon / 2) ** 2
    )
    return 2.0 * EARTH_RADIUS_M * np.arcsin(np.sqrt(np.clip(a, 0.0, 1.0)))
