"""TubeSelectProcess and tube builders.

The counterpart of the reference package's `process/tube.py`. Parity:
geomesa-process tube/ (TubeSelectProcess, TubeBuilder: NoGapFill,
LineGapFill, InterpolatedGapFill) [upstream, unverified]. The builders
turn an input track (points with times) into tube samples on the host;
the match against the target layer runs as one device pass
(engine.tube.tube_select_pruned) over the candidates of the track's
buffered window, in f64.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import numpy as np
import torch

from geomesa_tpu_torch.core.columnar import FeatureBatch
from geomesa_tpu_torch.cql.extract import BBox
from geomesa_tpu_torch.engine.device import VALID, fetch, resolve_device, to_device
from geomesa_tpu_torch.engine.geodesy import haversine_m_np
from geomesa_tpu_torch.engine.tube import tube_select_pruned
from geomesa_tpu_torch.plan.datastore import FeatureSource
from geomesa_tpu_torch.process.util import candidates_for


@dataclasses.dataclass
class Tube:
    x: np.ndarray
    y: np.ndarray
    t: np.ndarray  # epoch millis
    radius_m: float
    half_window_ms: int


class TubeBuilder:
    def build(self, track: FeatureBatch, radius_m: float,
              half_window_ms: int) -> Tube:
        x, y, t = _track_arrays(track)
        return Tube(*self._samples(x, y, t), radius_m, half_window_ms)

    def _samples(self, x, y, t):
        raise NotImplementedError


class NoGapFill(TubeBuilder):
    """Buffer each input point with its own time (no interpolation)."""

    def _samples(self, x, y, t):
        return x, y, t


class LineGapFill(TubeBuilder):
    """Interpolate positions along lines between consecutive points, and
    times linearly along each segment, with samples at most `max_sample_m`
    apart (upstream LineGapFill interpolates the geometry)."""

    def __init__(self, max_sample_m: float = 10_000.0):
        self.max_sample_m = max_sample_m

    def _samples(self, x, y, t):
        xs, ys, ts = [x[:1]], [y[:1]], [t[:1]]
        for i in range(len(x) - 1):
            d = float(haversine_m_np(x[i], y[i], x[i + 1], y[i + 1]))
            n = max(1, int(np.ceil(d / self.max_sample_m)))
            frac = np.linspace(0.0, 1.0, n + 1)[1:]
            xs.append(x[i] + frac * (x[i + 1] - x[i]))
            ys.append(y[i] + frac * (y[i + 1] - y[i]))
            ts.append((t[i] + frac * (t[i + 1] - t[i])).astype(np.int64))
        return np.concatenate(xs), np.concatenate(ys), np.concatenate(ts)


class InterpolatedGapFill(LineGapFill):
    """Same sampling; a distinct name for parity with the upstream variant
    (which additionally smooths headings)."""


class TubeSelectProcess:
    name = "TubeSelectProcess"

    def execute(self, tube_features: FeatureBatch,
                data: Union[FeatureSource, FeatureBatch],
                fill: Optional[TubeBuilder] = None,
                buffer_m: float = 10_000.0,
                max_time_window_ms: int = 3_600_000,
                cql_filter: str = "INCLUDE",
                device: "str | torch.device | None" = None) -> FeatureBatch:
        """The features of `data` within `buffer_m` and
        `max_time_window_ms` of the track. A source runs on its own
        device; a batch runs on `device` (None: the card)."""
        fill = fill or NoGapFill()
        tube = fill.build(tube_features, buffer_m, max_time_window_ms)
        bbox = BBox(
            float(tube.x.min()), float(tube.y.min()),
            float(tube.x.max()), float(tube.y.max()),
        ).buffer_degrees(buffer_m)
        dev_ = (data.planner.device if isinstance(data, FeatureSource)
                else resolve_device(device))
        candidates = candidates_for(data, bbox, cql_filter, device=dev_)
        if candidates is None or len(candidates) == 0:
            return tube_features.select(np.zeros(0, np.int64))

        dev = to_device(candidates, dev_, coord_dtype=torch.float64)
        g = candidates.sft.default_geometry
        d = candidates.sft.default_dtg
        # tile-pruned corridor join: data tiles outside the corridor's
        # per-segment reach are never scanned; exact for any order, fast
        # when candidates arrive in store (Z) order
        mask, _cap = tube_select_pruned(
            dev[f"{g.name}__x"], dev[f"{g.name}__y"], dev[d.name], dev[VALID],
            torch.from_numpy(tube.x).to(dev_), torch.from_numpy(tube.y).to(dev_),
            torch.from_numpy(tube.t).to(dev_), tube.radius_m,
            tube.half_window_ms)
        (mask,) = fetch(mask)
        return candidates.select(mask)


def _track_arrays(track: FeatureBatch):
    g = track.geometry
    d = track.dtg
    if d is None:
        raise ValueError("tube features need a date attribute")
    order = np.argsort(np.asarray(d))
    return (np.asarray(g.x)[order], np.asarray(g.y)[order],
            np.asarray(d)[order])
