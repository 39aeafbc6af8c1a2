"""Lane classification and membership for standing geofences.

The host side of the parametric lanes (engine/lanes.py): classify a
parsed CQL predicate into a geofence CLASS (bbox, dwithin, polygon)
whose parameters fit one row of a per-class [S, P] table, or return a
typed ineligibility reason and leave the subscription on the fused
path. Membership is a table-shape contract: tables are padded to pow2
[S]-buckets (polygon edge tables also to pow2 E-buckets) with an
`active` column, so register/cancel/pause are a ROW write; a table is
reallocated only when its bucket grows.

Eligibility:

- ``bbox``    — a bare BBOX on the default Point geometry.
- ``dwithin`` — DWITHIN against a single-point literal (BEYOND and
  segment/multi-point literals keep the fused path: they compile to
  different arithmetic).
- ``polygon`` — INTERSECTS/WITHIN against an area literal (polygon /
  multipolygon / geometry collection edge tables).

Anything else — compound filters, attribute predicates, negations,
extended-geometry data — is `lane_ineligible` with the reason on
stats, and evaluates on the fused path.

A copy of the reference package's `subscribe/lanes.py`, but for the
dwithin row: the reference's lane takes the centre's radians in f32,
as its compiled filter does; the port's compiled filter takes them (and
the latitude's cosine) in f64 and rounds them where they meet the f32
column, so the row carries those rounded values (engine/lanes.py). The
tables live on the host and are copied to the device per dispatch
(a few hundred KB at most).
"""

from __future__ import annotations

import math
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from geomesa_tpu_torch.cql import ast
from geomesa_tpu_torch.cql.compile import f32_ulp_band
from geomesa_tpu_torch.utils.padding import next_pow2

LANE_CLASSES = ("bbox", "dwithin", "polygon")

_ROW_MIN = 8     # smallest [S]-bucket (row capacities are pow2)
_EDGE_MIN = 8    # smallest polygon E-bucket
# degenerate pad-edge coordinate: far enough that no crossing
# condition or band term can fire for real (lon, lat) points
_FAR = np.float32(1.0e30)

# params-row widths per class (bbox: 4 extents + 4 band half-widths;
# dwithin: centre lon/lat in radians, cos(lat), meters)
_WIDTHS = {"bbox": 8, "dwithin": 4}


class LaneSpec:
    """One classified predicate: its class and parameter row."""

    __slots__ = ("cls", "params", "edges")

    def __init__(self, cls: str, params: Optional[np.ndarray] = None,
                 edges: Optional[np.ndarray] = None):
        self.cls = cls
        self.params = params   # [P] f32 (bbox / dwithin)
        self.edges = edges     # [4, E] f32 (polygon)


def classify(f, sft) -> Tuple[Optional[LaneSpec], str]:
    """(spec, "") for a lane-eligible filter AST, (None, reason)
    otherwise. The reasons are the typed `lane_ineligible` vocabulary
    surfaced on evaluator stats."""
    if isinstance(f, (ast.And, ast.Or, ast.Not)):
        return None, "compound"
    if isinstance(f, ast.SpatialPredicate):
        ok, why = _default_point_geom(f, sft)
        if not ok:
            return None, why
        if f.op == "BBOX":
            x0, y0, x1, y1 = f.geometry.bbox
            prm = np.array(
                [x0, x1, y0, y1,
                 f32_ulp_band(x0), f32_ulp_band(x1),
                 f32_ulp_band(y0), f32_ulp_band(y1)], np.float32)
            return LaneSpec("bbox", params=prm), ""
        if f.op in ("INTERSECTS", "WITHIN"):
            g = f.geometry
            if g.kind in ("Point", "MultiPoint",
                          "LineString", "MultiLineString"):
                return None, "non_area_literal"
            from geomesa_tpu_torch.engine.pip import polygon_edges

            x1e, y1e, x2e, y2e = polygon_edges(g)
            if len(x1e) == 0:
                return None, "empty_geometry"
            # f64 -> f32 by np cast: the compiled filter's DeviceTables
            # rounding of the same edge table
            edges = np.stack([x1e, y1e, x2e, y2e]).astype(np.float32)
            return LaneSpec("polygon", edges=edges), ""
        return None, "spatial_op"
    if isinstance(f, ast.DistancePredicate):
        ok, why = _default_point_geom(f, sft)
        if not ok:
            return None, why
        if f.op != "DWITHIN":
            return None, "negated"
        g = f.geometry
        if (g.kind not in ("Point", "MultiPoint")
                or sum(len(r) for r in g.rings) != 1):
            return None, "segment_literal"
        px, py = (float(v) for v in g.point)
        # engine.geodesy.haversine_m's weak scalars: math in f64, then
        # the f32 rounding the column applies
        rlat = math.radians(py)
        prm = np.array([math.radians(px), rlat, math.cos(rlat),
                        float(f.distance_m)], np.float32)
        return LaneSpec("dwithin", params=prm), ""
    return None, "non_spatial"


def _default_point_geom(f, sft) -> Tuple[bool, str]:
    g = sft.default_geometry
    if g is None or f.prop.name != g.name:
        return False, "non_default_geometry"
    if g.type != "Point":
        # extended-geometry data compiles through engine.geometry's CSR
        # masks — a different arithmetic the lane cannot reproduce
        return False, "extended_geometry"
    return True, ""


class LaneGroup:
    """One lane's parameter table: pow2-capacity rows + active column.

    Mutated only under the evaluator's per-type eval lock (the fold
    serialization boundary), so row assignment needs no lock of its
    own. Rows are recycled through a free list; capacity doubles
    through `next_pow2` when full — the only event that reallocates the
    table (`allocations` counts them)."""

    def __init__(self, cls: str, ebucket: int = 0):
        self.cls = cls
        self.ebucket = ebucket           # polygon only: padded E
        cap = next_pow2(_ROW_MIN)
        self.cap = cap
        self.params = self._alloc(cap)
        self.active = np.zeros(cap, bool)
        self.rows: Dict[str, int] = {}   # sub_id -> row
        self.free: List[int] = []
        self._used = 0
        self.allocations = 1

    def _alloc(self, cap: int) -> np.ndarray:
        if self.cls == "polygon":
            return np.full((cap, 4, self.ebucket), _FAR, np.float32)
        return np.zeros((cap, _WIDTHS[self.cls]), np.float32)

    def assign(self, sub_id: str, spec: LaneSpec) -> int:
        """Write one geofence into a free row (growing the bucket when
        full) and activate it. The steady-state cost of registration."""
        t0 = time.perf_counter()
        if self.free:
            row = self.free.pop()
        else:
            if self._used >= self.cap:
                self._grow()
            row = self._used
            self._used += 1
        if self.cls == "polygon":
            self.params[row] = _FAR
            self.params[row, :, : spec.edges.shape[1]] = spec.edges
        else:
            self.params[row] = spec.params
        self.active[row] = True
        self.rows[sub_id] = row
        try:
            from geomesa_tpu_torch.utils.metrics import metrics

            metrics.histogram("lane.param_write").update(
                time.perf_counter() - t0)
        except Exception:
            pass  # observability must never fail registration
        return row

    def release(self, sub_id: str) -> None:
        row = self.rows.pop(sub_id, None)
        if row is None:
            return
        self.active[row] = False
        self.free.append(row)

    def _grow(self) -> None:
        cap = next_pow2(self.cap + 1)
        params = self._alloc(cap)
        params[: self.cap] = self.params
        active = np.zeros(cap, bool)
        active[: self.cap] = self.active
        self.cap, self.params, self.active = cap, params, active
        self.allocations += 1

    def occupancy(self) -> int:
        return len(self.rows)


class LaneTable:
    """Per-feature-type lane membership: the diff between the current
    active subscription set and the assigned rows, applied as row
    writes. Owned by the evaluator's _TypeState; every method runs
    under the per-type eval lock."""

    def __init__(self):
        # group key: ("bbox",) / ("dwithin",) / ("polygon", E-bucket)
        self.groups: Dict[tuple, LaneGroup] = {}
        self.assigned: Dict[str, tuple] = {}  # sub_id -> group key
        self.reasons: Dict[str, str] = {}     # sub_id -> ineligible why

    def sync(self, subs, spec_for: Callable) -> Tuple[list, list]:
        """Reconcile membership with one atomic registry snapshot.

        Returns (lanes, remainder): `lanes` is [(group, [(sub, row)])]
        for every group with members in `subs`; `remainder` is every
        subscription staying on the fused path (densities + ineligible
        predicates), in registration order. Newly seen predicates are
        classified once and cached by sub_id; subscriptions gone from
        the active set release their rows (a row write — pause/cancel
        never rebuilds anything)."""
        members: Dict[tuple, list] = {}
        remainder = []
        seen = {sub.sub_id for sub in subs if sub.density is None}
        # release rows of subscriptions gone from the active set BEFORE
        # assigning newcomers: a cancel+register cycle at full capacity
        # must recycle the cancelled row, not grow the bucket
        for sid in [s for s in self.assigned if s not in seen]:
            self.groups[self.assigned.pop(sid)].release(sid)
        for sid in [s for s in self.reasons if s not in seen]:
            del self.reasons[sid]
        for sub in subs:
            if sub.density is not None:
                remainder.append(sub)
                continue
            sid = sub.sub_id
            key = self.assigned.get(sid)
            if key is None and sid not in self.reasons:
                spec, reason = spec_for(sub)
                if spec is None:
                    self.reasons[sid] = reason
                else:
                    key = self._assign(sid, spec)
            if key is None:
                remainder.append(sub)
                continue
            members.setdefault(key, []).append(
                (sub, self.groups[key].rows[sid]))
        self._export_gauges()
        return ([(self.groups[k], members[k])
                 for k in sorted(members)], remainder)

    def _assign(self, sub_id: str, spec: LaneSpec) -> tuple:
        if spec.cls == "polygon":
            eb = next_pow2(max(spec.edges.shape[1], _EDGE_MIN))
            key = ("polygon", eb)
        else:
            key = (spec.cls,)
        group = self.groups.get(key)
        if group is None:
            group = self.groups[key] = LaneGroup(
                spec.cls, ebucket=key[1] if spec.cls == "polygon" else 0)
        group.assign(sub_id, spec)
        self.assigned[sub_id] = key
        return key

    def _export_gauges(self) -> None:
        try:
            from geomesa_tpu_torch.utils.metrics import metrics

            per_cls: Dict[str, int] = {}
            for g in self.groups.values():
                per_cls[g.cls] = per_cls.get(g.cls, 0) + g.occupancy()
            for cls in LANE_CLASSES:
                metrics.gauge("subscribe.lanes", float(per_cls.get(cls, 0)),
                              **{"class": cls})
        except Exception:
            pass  # observability must never fail the fold

    def stats(self) -> dict:
        classes: Dict[str, dict] = {}
        for key, g in sorted(self.groups.items()):
            c = classes.setdefault(g.cls, {"rows": 0, "capacity": 0})
            c["rows"] += g.occupancy()
            c["capacity"] += g.cap
        ineligible: Dict[str, int] = {}
        for why in self.reasons.values():
            ineligible[why] = ineligible.get(why, 0) + 1
        return {"classes": classes, "ineligible": ineligible}
