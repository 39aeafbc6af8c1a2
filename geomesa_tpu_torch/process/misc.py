"""The remaining vector processes.

The counterpart of the reference package's `process/misc.py`:
ProximitySearchProcess (the 1-NN haversine of `engine/knn.py`, in f64 on
`device`), QueryProcess, SamplingProcess, StatsProcess (a stats query:
`plan.runner.run_stats`), UniqueProcess, JoinProcess, Point2PointProcess,
DateOffsetProcess, HashAttributeProcess and RouteSearchProcess (host
NumPy, as in the reference), ArrowConversionProcess (the matching
features as Arrow IPC bytes, `core/arrow_io.py`) and BinConversionProcess
(a `bin_track` query: BIN records packed on the source's device,
`engine/bin.py`).
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from geomesa_tpu_torch.core.columnar import DictColumn, FeatureBatch, GeometryColumn
from geomesa_tpu_torch.core.sft import AttributeDescriptor, SimpleFeatureType
from geomesa_tpu_torch.engine.device import fetch, resolve_device, to_device
from geomesa_tpu_torch.plan.datastore import FeatureSource
from geomesa_tpu_torch.plan.hints import QueryHints
from geomesa_tpu_torch.plan.query import Query


class ProximitySearchProcess:
    """Features of `data` within `distance_m` of ANY input feature."""

    name = "ProximitySearchProcess"

    def execute(
        self,
        input_features: FeatureBatch,
        data: "FeatureSource | FeatureBatch",
        distance_m: float,
        cql_filter: str = "INCLUDE",
        device=None,
    ) -> FeatureBatch:
        """`device` (default: the card) runs the 1-NN pass, and filters
        `data` when it is a batch; a source's window query runs on the
        source's own device."""
        from geomesa_tpu_torch.cql.extract import BBox
        from geomesa_tpu_torch.engine.knn import knn
        from geomesa_tpu_torch.process.util import candidates_for

        dev = resolve_device(device)
        g_in = input_features.geometry
        bbox = BBox(
            float(np.min(g_in.x)), float(np.min(g_in.y)),
            float(np.max(g_in.x)), float(np.max(g_in.y)),
        ).buffer_degrees(distance_m)
        candidates = candidates_for(data, bbox, cql_filter, device=dev)
        if candidates is None or len(candidates) == 0:
            return input_features.select(np.zeros(0, np.int64))
        dv = to_device(candidates, dev, coord_dtype=torch.float64)
        g = candidates.sft.default_geometry

        def f64(a) -> torch.Tensor:
            return torch.from_numpy(np.asarray(a, np.float64)).to(dev)

        # nearest input point per candidate: 1-NN with roles swapped
        d, _ = knn(
            dv[f"{g.name}__x"], dv[f"{g.name}__y"], f64(g_in.x), f64(g_in.y),
            torch.ones(len(g_in.x), dtype=torch.bool, device=dev), k=1,
            query_tile=min(1024, len(candidates)),
        )
        (d0,) = fetch(d[:, 0])
        mask = d0 <= distance_m
        valid = candidates.valid if candidates.valid is not None else np.ones(len(candidates), bool)
        return candidates.select(mask & valid)


class QueryProcess:
    """Run an ECQL query as a process (chaining primitive)."""

    name = "QueryProcess"

    def execute(self, data: FeatureSource, cql: str) -> FeatureBatch:
        r = data.get_features(Query(data.sft.name, cql))
        return r.features


class SamplingProcess:
    """Statistical thinning (every n-th match)."""

    name = "SamplingProcess"

    def execute(
        self, data: FeatureSource, n: int, cql_filter: str = "INCLUDE"
    ) -> FeatureBatch:
        q = Query(data.sft.name, cql_filter, hints=QueryHints(sampling=n))
        return data.get_features(q).features


class StatsProcess:
    """Evaluate a Stat DSL expression over matches (rides StatsScan)."""

    name = "StatsProcess"

    def execute(self, data: FeatureSource, stats: str, cql_filter: str = "INCLUDE"):
        q = Query(data.sft.name, cql_filter, hints=QueryHints(stats_string=stats))
        return data.get_features(q).stats


class UniqueProcess:
    """Distinct values of an attribute with counts."""

    name = "UniqueProcess"

    def execute(
        self, data: FeatureSource, attribute: str, cql_filter: str = "INCLUDE"
    ) -> List[Tuple[str, int]]:
        q = Query(
            data.sft.name, cql_filter,
            hints=QueryHints(stats_string=f"Enumeration({attribute})"),
        )
        stats = data.get_features(q).stats
        counts = stats.stats[0].result()
        return sorted(counts.items(), key=lambda kv: (-kv[1], kv[0]))


class JoinProcess:
    """Attribute equi-join: enrich `left` with columns of `right` matched on
    left.attr == right.attr (first match wins, inner join)."""

    name = "JoinProcess"

    def execute(
        self,
        left: FeatureBatch,
        right: FeatureBatch,
        left_attr: str,
        right_attr: str,
        right_attributes: Optional[Sequence[str]] = None,
    ) -> FeatureBatch:
        lcol = left.columns[left_attr]
        rcol = right.columns[right_attr]
        lvals = lcol.decode() if isinstance(lcol, DictColumn) else np.asarray(lcol).tolist()
        rvals = rcol.decode() if isinstance(rcol, DictColumn) else np.asarray(rcol).tolist()
        lookup = {}
        for i, v in enumerate(rvals):
            if v is not None and v not in lookup:
                lookup[v] = i
        lidx, ridx = [], []
        for i, v in enumerate(lvals):
            j = lookup.get(v)
            if j is not None:
                lidx.append(i)
                ridx.append(j)
        lsel = left.select(np.asarray(lidx, np.int64))
        rsel = right.select(np.asarray(ridx, np.int64))
        cols = dict(lsel.columns)
        attrs = list(lsel.sft.attributes)
        names = set(lsel.sft.attribute_names)
        wanted = right_attributes or [
            a.name for a in right.sft.attributes if not a.is_geometry
        ]
        for aname in wanted:
            a = right.sft.attribute(aname)
            out = aname if aname not in names else f"right_{aname}"
            attrs.append(AttributeDescriptor(out, a.type, False, dict(a.options)))
            cols[out] = rsel.columns[aname]
        sft = SimpleFeatureType(f"{left.sft.name}_join", attrs, dict(lsel.sft.user_data))
        return FeatureBatch(sft, cols, lsel.fids, lsel.valid)


class Point2PointProcess:
    """Convert per-track point sequences into LineString tracks."""

    name = "Point2PointProcess"

    def execute(
        self, data: FeatureBatch, track_attr: str, dtg_attr: Optional[str] = None
    ) -> FeatureBatch:
        from geomesa_tpu_torch.core.wkt import Geometry

        g = data.geometry
        d = data.columns[dtg_attr] if dtg_attr else data.dtg
        tcol = data.columns[track_attr]
        tracks = tcol.decode() if isinstance(tcol, DictColumn) else np.asarray(tcol).tolist()
        order = np.argsort(np.asarray(d), kind="stable") if d is not None else np.arange(len(data))
        by_track = {}
        for i in order:
            key = tracks[int(i)]
            if key is not None:
                by_track.setdefault(key, []).append(int(i))
        names, geoms = [], []
        for key, idxs in by_track.items():
            if len(idxs) < 2:
                continue
            pts = np.stack([np.asarray(g.x)[idxs], np.asarray(g.y)[idxs]], axis=1)
            names.append(str(key))
            geoms.append(Geometry("LineString", [pts]))
        sft = SimpleFeatureType(
            f"{data.sft.name}_tracks",
            [
                AttributeDescriptor("track", "String"),
                AttributeDescriptor("geom", "LineString", True),
            ],
        )
        return FeatureBatch(
            sft,
            {
                "track": DictColumn.encode(names),
                "geom": GeometryColumn.from_geometries(geoms),
            },
        )


class DateOffsetProcess:
    """Shift a date attribute by a fixed offset (upstream utility)."""

    name = "DateOffsetProcess"

    def execute(self, data: FeatureBatch, dtg_attr: str, offset_ms: int) -> FeatureBatch:
        cols = dict(data.columns)
        cols[dtg_attr] = np.asarray(cols[dtg_attr], np.int64) + int(offset_ms)
        return FeatureBatch(data.sft, cols, data.fids, data.valid)


class HashAttributeProcess:
    """Add a stable int hash (mod `modulo`) of an attribute — upstream's
    HashAttribute(Color)Process used for stable symbology binning."""

    name = "HashAttributeProcess"

    def execute(self, data: FeatureBatch, attr: str, modulo: int = 256) -> FeatureBatch:
        col = data.columns[attr]
        vals = col.decode() if isinstance(col, DictColumn) else np.asarray(col).tolist()
        h = np.array(
            [
                int.from_bytes(
                    hashlib.blake2b(str(v).encode(), digest_size=4).digest(), "big"
                ) % modulo if v is not None else -1
                for v in vals
            ],
            np.int32,
        )
        attrs = list(data.sft.attributes) + [AttributeDescriptor("hash", "Integer")]
        sft = SimpleFeatureType(data.sft.name, attrs, dict(data.sft.user_data))
        cols = dict(data.columns)
        cols["hash"] = h
        return FeatureBatch(sft, cols, data.fids, data.valid)


class RouteSearchProcess:
    """Features along a route whose heading matches the route direction.

    Parity: RouteSearchProcess [L in the survey]: DWITHIN of the route line
    AND |heading - route bearing at nearest segment| <= tolerance.
    """

    name = "RouteSearchProcess"

    def execute(
        self,
        data: FeatureBatch,
        route_wkt: str,
        buffer_m: float,
        heading_attr: str,
        heading_tolerance_deg: float = 45.0,
        bidirectional: bool = False,
    ) -> FeatureBatch:
        from geomesa_tpu_torch.core.wkt import parse_wkt
        from geomesa_tpu_torch.engine.pip import polygon_edges

        route = parse_wkt(route_wkt)
        x1, y1, x2, y2 = polygon_edges(route)
        g = data.geometry
        px, py = np.asarray(g.x), np.asarray(g.y)
        # nearest segment + distance (host numpy: routes are small)
        deg_m = 111_194.9
        coslat = np.cos(np.radians(py))[:, None]
        ax = (x1[None, :] - px[:, None]) * deg_m * coslat
        ay = (y1[None, :] - py[:, None]) * deg_m
        bx = (x2[None, :] - px[:, None]) * deg_m * coslat
        by = (y2[None, :] - py[:, None]) * deg_m
        dx, dy = bx - ax, by - ay
        L2 = np.maximum(dx * dx + dy * dy, 1e-12)
        t = np.clip(-(ax * dx + ay * dy) / L2, 0, 1)
        cx, cy = ax + t * dx, ay + t * dy
        dist = np.sqrt(cx * cx + cy * cy)
        seg = np.argmin(dist, axis=1)
        near = dist[np.arange(len(px)), seg] <= buffer_m
        bearing = (np.degrees(np.arctan2(dx, dy)) % 360.0)[np.arange(len(px)), seg]
        heading = np.asarray(data.columns[heading_attr], np.float64)
        diff = np.abs((heading - bearing + 180.0) % 360.0 - 180.0)
        if bidirectional:
            diff = np.minimum(diff, np.abs(diff - 180.0))
        ok = near & (diff <= heading_tolerance_deg)
        valid = data.valid if data.valid is not None else np.ones(len(data), bool)
        return data.select(ok & valid)


class ArrowConversionProcess:
    """Encode matching features as Arrow IPC bytes (empty bytes when no
    feature matches, as in the reference)."""

    name = "ArrowConversionProcess"

    def execute(self, data: FeatureSource, cql_filter: str = "INCLUDE") -> bytes:
        import io

        import pyarrow as pa

        from geomesa_tpu_torch.core.arrow_io import to_arrow

        r = data.get_features(Query(data.sft.name, cql_filter))
        if r.features is None or len(r.features) == 0:
            return b""
        rb = to_arrow(r.features)
        sink = io.BytesIO()
        with pa.ipc.new_stream(sink, rb.schema) as w:
            w.write_batch(rb)
        return sink.getvalue()


class BinConversionProcess:
    """Encode matching features as BIN records."""

    name = "BinConversionProcess"

    def execute(
        self, data: FeatureSource, track_attr: str, cql_filter: str = "INCLUDE"
    ) -> bytes:
        q = Query(data.sft.name, cql_filter, hints=QueryHints(bin_track=track_attr))
        return data.get_features(q).bin_bytes
