"""Columnar feature batches (host side).

A copy of the reference package's `core/columnar.py`:

- numeric columns: f64/f32/i64/i32/bool NumPy arrays
- String/UUID columns: dictionary-encoded int32 codes + host vocab
- Date/Timestamp: int64 epoch millis
- geometry: point fast path (x[N], y[N] f64) or CSR for extended geometries
  (vertex buffer [V,2] f64 + ring offsets + per-feature ring slices + bbox[N,4]),
  with the memoised flat `EdgeTable` (shells CCW, holes CW)

Batches are immutable; `select`/`pad_to` return new batches. Padding carries a
validity mask so fixed-shape device kernels can AND it into predicate masks.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, List, Optional, Sequence, Union

import numpy as np

from geomesa_tpu_torch.core.sft import SimpleFeatureType
from geomesa_tpu_torch.core.wkt import Geometry


@dataclasses.dataclass
class DictColumn:
    """Dictionary-encoded string column: int32 codes (-1 = null) + vocab."""

    codes: np.ndarray
    vocab: List[str]

    def __len__(self) -> int:
        return len(self.codes)

    def take(self, idx) -> "DictColumn":
        return DictColumn(self.codes[idx], self.vocab)

    def decode(self) -> List[Optional[str]]:
        return [self.vocab[c] if c >= 0 else None for c in self.codes]

    @classmethod
    def encode(cls, values: Sequence[Optional[str]]) -> "DictColumn":
        vocab: List[str] = []
        lookup: Dict[str, int] = {}
        codes = np.empty(len(values), dtype=np.int32)
        for i, v in enumerate(values):
            if v is None:
                codes[i] = -1
            else:
                code = lookup.get(v)
                if code is None:
                    code = len(vocab)
                    lookup[v] = code
                    vocab.append(v)
                codes[i] = code
        return cls(codes, vocab)

    @classmethod
    def concat(cls, parts: Sequence["DictColumn"]) -> "DictColumn":
        """Vocab-merge concat: O(sum vocab) dict work + vectorized code
        remaps — decode()+encode() over every ROW costs a Python loop per
        element and dominated superbatch rebuilds at millions of rows."""
        vocab: List[str] = []
        lookup: Dict[str, int] = {}
        out = []
        for p in parts:
            remap = np.empty(len(p.vocab) + 1, dtype=np.int32)
            remap[-1] = -1  # null code -1 indexes the sentinel slot
            for j, v in enumerate(p.vocab):
                code = lookup.get(v)
                if code is None:
                    code = len(vocab)
                    lookup[v] = code
                    vocab.append(v)
                remap[j] = code
            out.append(remap[p.codes])
        return cls(np.concatenate(out) if out else np.empty(0, np.int32), vocab)


@dataclasses.dataclass
class EdgeTable:
    """Flat edge table over a GeometryColumn's CSR buffers.

    The device layout the extended-geometry kernels reduce over: edges as
    parallel (x1, y1, x2, y2) arrays with per-edge feature ids. For polygon
    kinds, rings are closed and ORIENTED (outer shells CCW, holes CW) so
    winding-number accumulation over the flat table is well-defined — the
    density rasterizer (engine.raster) relies on this; parity-based
    predicates (crossing number) are orientation-independent, so the
    normalization is safe for every consumer.
    """

    vfeat: np.ndarray  # [V] i32 feature id per vertex
    x1: np.ndarray
    y1: np.ndarray
    x2: np.ndarray
    y2: np.ndarray
    efeat: np.ndarray  # [E] i32 feature id per edge


@dataclasses.dataclass
class GeometryColumn:
    """Columnar geometry.

    Point layout: x[N], y[N] (f64). Extended layout additionally carries the
    CSR buffers; for points the CSR fields are None.

    CSR layout (kind != Point):
      vertices:      [V, 2] f64 — all ring vertices, concatenated
      ring_offsets:  [R+1] i64  — ring r = vertices[ring_offsets[r]:ring_offsets[r+1]]
      feature_rings: [N+1] i64  — feature i owns rings feature_rings[i]:feature_rings[i+1]
      feature_parts: list of per-feature part sizes (for Multi* reconstruction)
      bbox:          [N, 4] f64 — (xmin, ymin, xmax, ymax) per feature
    x/y for extended geometries hold a representative point (first vertex),
    used only as a cheap prefilter aid, never for exact predicates.
    """

    kind: str
    x: np.ndarray
    y: np.ndarray
    vertices: Optional[np.ndarray] = None
    ring_offsets: Optional[np.ndarray] = None
    feature_rings: Optional[np.ndarray] = None
    feature_parts: Optional[List[List[int]]] = None
    bbox: Optional[np.ndarray] = None
    # per-feature base-kind codes (0=point, 1=line, 2=polygon), populated
    # only for mixed "Geometry"/"GeometryCollection" columns where the
    # column kind cannot speak for each feature — kernels that dispatch on
    # geometry kind (density rasterization) split on these instead of
    # treating every feature as polygonal (which cancels line/point
    # contributions to zero via edge-closure winding)
    feature_kinds: Optional[np.ndarray] = None
    _edges: Optional[EdgeTable] = dataclasses.field(
        default=None, init=False, repr=False, compare=False
    )
    _memo: dict = dataclasses.field(
        default_factory=dict, init=False, repr=False, compare=False
    )

    def __len__(self) -> int:
        return len(self.x)

    @property
    def is_polygonal(self) -> bool:
        return "Polygon" in self.kind or self.kind in (
            "Geometry",
            "GeometryCollection",
        )

    def memo(self, key, compute):
        """A value derived from this column's geometry (which never
        changes), computed once per key: the rasterizers' static budgets."""
        got = self._memo.get(key)
        if got is None:
            got = self._memo[key] = compute()
        return got

    def edge_table(self) -> EdgeTable:
        """Vectorized (memoized) edge-table build — see EdgeTable.

        O(V) NumPy instead of a per-feature Python loop: at the 1M-polygon
        scale the loop version took tens of seconds per upload.
        """
        if self._edges is not None:
            return self._edges
        if self.is_point:
            raise ValueError("point columns have no edge table")
        vx = self.vertices[:, 0]
        vy = self.vertices[:, 1]
        nv = len(vx)
        ring_len = np.diff(self.ring_offsets)
        nring = len(ring_len)
        ring_id = np.repeat(np.arange(nring, dtype=np.int64), ring_len)
        feat_of_ring = np.repeat(
            np.arange(len(self), dtype=np.int32), np.diff(self.feature_rings)
        )
        vfeat = (
            feat_of_ring[ring_id] if nv else np.zeros(0, np.int32)
        ).astype(np.int32)
        # open edges: consecutive vertex pairs within the same ring
        if nv > 1:
            i0 = np.nonzero(ring_id[:-1] == ring_id[1:])[0]
        else:
            i0 = np.zeros(0, np.int64)
        x1, y1 = vx[i0], vy[i0]
        x2, y2 = vx[i0 + 1], vy[i0 + 1]
        ering = ring_id[i0] if nv else np.zeros(0, np.int64)
        if self.is_polygonal:
            # closure edges for rings not already closed
            first = self.ring_offsets[:-1]
            last = self.ring_offsets[1:] - 1
            ci = np.nonzero(ring_len >= 2)[0]
            ci = ci[
                (vx[first[ci]] != vx[last[ci]])
                | (vy[first[ci]] != vy[last[ci]])
            ]
            x1 = np.concatenate([x1, vx[last[ci]]])
            y1 = np.concatenate([y1, vy[last[ci]]])
            x2 = np.concatenate([x2, vx[first[ci]]])
            y2 = np.concatenate([y2, vy[first[ci]]])
            ering = np.concatenate([ering, ci])
            # ring orientation: shells CCW (signed area > 0), holes CW.
            # ring r of each part with local index 0 is the shell (WKT rule).
            area2 = np.bincount(
                ering, weights=x1 * y2 - x2 * y1, minlength=nring
            )
            part_sizes = np.fromiter(
                (p for plist in self.feature_parts for p in plist),
                dtype=np.int64,
            )
            shell = np.zeros(nring, dtype=bool)
            if len(part_sizes):
                starts = np.concatenate([[0], np.cumsum(part_sizes)[:-1]])
                shell[starts[starts < nring]] = True
            flip_ring = np.where(shell, area2 < 0, area2 > 0) & (area2 != 0)
            fm = flip_ring[ering]
            x1, x2 = np.where(fm, x2, x1), np.where(fm, x1, x2)
            y1, y2 = np.where(fm, y2, y1), np.where(fm, y1, y2)
        efeat = (
            feat_of_ring[ering] if len(ering) else np.zeros(0, np.int32)
        ).astype(np.int32)
        self._edges = EdgeTable(vfeat, x1, y1, x2, y2, efeat)
        return self._edges

    @property
    def is_point(self) -> bool:
        return self.vertices is None

    @classmethod
    def from_points(cls, x, y) -> "GeometryColumn":
        return cls(
            "Point",
            np.asarray(x, dtype=np.float64),
            np.asarray(y, dtype=np.float64),
        )

    @classmethod
    def from_geometries(
        cls, geoms: Sequence[Geometry], kind: Optional[str] = None
    ) -> "GeometryColumn":
        """`kind` pins the column's geometry type when `geoms` cannot speak
        for itself — an EMPTY list otherwise defaults to Point, which makes
        a zero-row batch's arrow schema (struct x,y) disagree with the
        feature type's declared non-Point layout (utf8/CSR)."""
        kinds = {g.kind for g in geoms} or ({kind} if kind else set())
        if kinds <= {"Point"}:
            xy = np.array([g.point for g in geoms], dtype=np.float64).reshape(-1, 2)
            return cls.from_points(xy[:, 0], xy[:, 1])
        kind = _unify_kind(kinds)
        vertices, ring_offsets, feature_rings = [], [0], [0]
        parts: List[List[int]] = []
        bbox = np.empty((len(geoms), 4), dtype=np.float64)
        xs = np.empty(len(geoms), dtype=np.float64)
        ys = np.empty(len(geoms), dtype=np.float64)
        for i, g in enumerate(geoms):
            for r in g.rings:
                vertices.append(r)
                ring_offsets.append(ring_offsets[-1] + len(r))
            feature_rings.append(feature_rings[-1] + len(g.rings))
            parts.append(list(g.parts))
            bbox[i] = g.bbox
            if g.rings:
                xs[i], ys[i] = g.rings[0][0]
            else:
                xs[i] = ys[i] = np.nan
        v = (
            np.concatenate(vertices, axis=0)
            if vertices
            else np.zeros((0, 2), dtype=np.float64)
        )
        fkinds = (
            np.array([_kind_code(g.kind) for g in geoms], dtype=np.int8)
            if kind in ("Geometry", "GeometryCollection")
            else None
        )
        return cls(
            kind,
            xs,
            ys,
            v,
            np.asarray(ring_offsets, dtype=np.int64),
            np.asarray(feature_rings, dtype=np.int64),
            parts,
            bbox,
            fkinds,
        )

    def geometry(self, i: int) -> Geometry:
        """Reconstruct the host Geometry for feature i."""
        if self.is_point:
            return Geometry(
                "Point", [np.array([[self.x[i], self.y[i]]], dtype=np.float64)]
            )
        r0, r1 = int(self.feature_rings[i]), int(self.feature_rings[i + 1])
        rings = [
            self.vertices[self.ring_offsets[r] : self.ring_offsets[r + 1]]
            for r in range(r0, r1)
        ]
        kind = self.kind
        if self.feature_kinds is not None:
            # mixed column: recover the feature's exact kind (Multi-ness
            # included) so density dispatch and WKT/schema round-trips
            # never change a feature's declared type
            code = int(self.feature_kinds[i])
            if code == 6:
                kind = "GeometryCollection"
            else:
                base = ("Point", "LineString", "Polygon")[code % 3]
                kind = base if code < 3 else f"Multi{base}"
        return Geometry(kind, rings, list(self.feature_parts[i]))

    def take(self, idx) -> "GeometryColumn":
        idx = np.asarray(idx)
        if self.is_point:
            return GeometryColumn(self.kind, self.x[idx], self.y[idx])
        # Vectorized CSR gather: per-feature ring slices -> new offset arrays.
        r0 = self.feature_rings[idx]
        r1 = self.feature_rings[idx + 1]
        ring_counts = r1 - r0
        new_feature_rings = np.concatenate([[0], np.cumsum(ring_counts)])
        # indices of selected rings, in output order
        ring_idx = (
            np.concatenate([np.arange(a, b) for a, b in zip(r0, r1)])
            if len(idx)
            else np.zeros(0, dtype=np.int64)
        )
        v0 = self.ring_offsets[ring_idx]
        v1 = self.ring_offsets[ring_idx + 1]
        vert_counts = v1 - v0
        new_ring_offsets = np.concatenate([[0], np.cumsum(vert_counts)])
        vert_idx = (
            np.concatenate([np.arange(a, b) for a, b in zip(v0, v1)])
            if len(ring_idx)
            else np.zeros(0, dtype=np.int64)
        )
        return GeometryColumn(
            self.kind,
            self.x[idx],
            self.y[idx],
            self.vertices[vert_idx],
            new_ring_offsets.astype(np.int64),
            new_feature_rings.astype(np.int64),
            [self.feature_parts[int(i)] for i in idx],
            self.bbox[idx],
            self.feature_kinds[idx] if self.feature_kinds is not None else None,
        )


def _unify_kind(kinds) -> str:
    """Smallest kind covering a mix: LineString+MultiLineString stays a
    line kind (NOT "Geometry", which edge_table/raster would treat as
    polygonal and close into phantom rings)."""
    if len(kinds) == 1:
        return next(iter(kinds))
    for base in ("Point", "LineString", "Polygon"):
        if kinds <= {base, f"Multi{base}"}:
            return f"Multi{base}"
    return "Geometry"


_KIND_CODES = {
    "Point": 0,
    "LineString": 1,
    "Polygon": 2,
    "MultiPoint": 3,
    "MultiLineString": 4,
    "MultiPolygon": 5,
}


def _kind_code(kind: str) -> int:
    """feature_kinds codes: 0-2 base kinds, 3-5 their Multi variants
    (code % 3 recovers the base for kernel dispatch), 6 =
    GeometryCollection (heterogeneous parts — no single base kind)."""
    return _KIND_CODES.get(kind, 6)


Column = Union[np.ndarray, DictColumn, GeometryColumn]


@dataclasses.dataclass
class FeatureBatch:
    """An immutable batch of features in columnar layout."""

    sft: SimpleFeatureType
    columns: Dict[str, Column]
    fids: Optional[DictColumn] = None
    valid: Optional[np.ndarray] = None  # bool [N]; None = all valid

    def __post_init__(self):
        n = len(self)
        for name, col in self.columns.items():
            if len(col) != n:
                raise ValueError(
                    f"column {name!r} has length {len(col)}, expected {n}"
                )

    def __len__(self) -> int:
        if not self.columns:
            return 0
        return len(next(iter(self.columns.values())))

    @property
    def geometry(self) -> Optional[GeometryColumn]:
        g = self.sft.default_geometry
        return self.columns[g.name] if g is not None else None  # type: ignore[return-value]

    @property
    def dtg(self) -> Optional[np.ndarray]:
        d = self.sft.default_dtg
        return self.columns[d.name] if d is not None else None  # type: ignore[return-value]

    def select(self, mask_or_idx) -> "FeatureBatch":
        arr = np.asarray(mask_or_idx)
        idx = np.nonzero(arr)[0] if arr.dtype == bool else arr
        cols = {
            name: (col[idx] if isinstance(col, np.ndarray) else col.take(idx))
            for name, col in self.columns.items()
        }
        fids = self.fids.take(idx) if self.fids is not None else None
        valid = self.valid[idx] if self.valid is not None else None
        return FeatureBatch(self.sft, cols, fids, valid)

    def pad_to(self, size: int) -> "FeatureBatch":
        """Pad all columns to `size`, extending the validity mask with False."""
        n = len(self)
        if size < n:
            raise ValueError("pad_to smaller than batch")
        if size == n and self.valid is not None:
            return self
        pad = size - n
        cols: Dict[str, Column] = {}
        for name, col in self.columns.items():
            if isinstance(col, np.ndarray):
                fill = np.zeros((pad,) + col.shape[1:], dtype=col.dtype)
                cols[name] = np.concatenate([col, fill])
            elif isinstance(col, DictColumn):
                cols[name] = DictColumn(
                    np.concatenate([col.codes, np.full(pad, -1, np.int32)]), col.vocab
                )
            else:  # GeometryColumn: pad point arrays; CSR padding = empty geoms
                if col.is_point:
                    cols[name] = GeometryColumn(
                        col.kind,
                        np.concatenate([col.x, np.zeros(pad)]),
                        np.concatenate([col.y, np.zeros(pad)]),
                    )
                else:
                    # vectorized: padded features own zero rings (same as
                    # appending empty geometries, without the per-feature
                    # object round-trip)
                    cols[name] = GeometryColumn(
                        col.kind,
                        np.concatenate([col.x, np.full(pad, np.nan)]),
                        np.concatenate([col.y, np.full(pad, np.nan)]),
                        col.vertices,
                        col.ring_offsets,
                        np.concatenate(
                            [
                                col.feature_rings,
                                np.full(
                                    pad, col.feature_rings[-1], dtype=np.int64
                                ),
                            ]
                        ),
                        col.feature_parts + [[0]] * pad,
                        np.concatenate(
                            [col.bbox, np.full((pad, 4), np.nan)]
                        ),
                        (
                            np.concatenate(
                                [col.feature_kinds, np.full(pad, 2, np.int8)]
                            )
                            if col.feature_kinds is not None
                            else None
                        ),
                    )
        fids = (
            DictColumn(
                np.concatenate([self.fids.codes, np.full(pad, -1, np.int32)]),
                self.fids.vocab,
            )
            if self.fids is not None
            else None
        )
        valid = (
            self.valid if self.valid is not None else np.ones(n, dtype=bool)
        )
        valid = np.concatenate([valid, np.zeros(pad, dtype=bool)])
        return FeatureBatch(self.sft, cols, fids, valid)

    @staticmethod
    def concat(batches: Sequence["FeatureBatch"]) -> "FeatureBatch":
        batches = [b for b in batches if len(b)]
        if not batches:
            raise ValueError("nothing to concat")
        if len(batches) == 1:
            return batches[0]
        sft = batches[0].sft
        cols: Dict[str, Column] = {}
        for name in batches[0].columns:
            parts = [b.columns[name] for b in batches]
            first = parts[0]
            if isinstance(first, np.ndarray):
                cols[name] = np.concatenate(parts)
            elif isinstance(first, DictColumn):
                cols[name] = DictColumn.concat(parts)
            elif all(p.is_point for p in parts):
                cols[name] = GeometryColumn.from_points(
                    np.concatenate([p.x for p in parts]),
                    np.concatenate([p.y for p in parts]),
                )
            elif all(not p.is_point for p in parts):
                # vectorized CSR concat: shift offset arrays
                voff = np.cumsum([0] + [len(p.vertices) for p in parts])
                roff = np.cumsum(
                    [0] + [len(p.ring_offsets) - 1 for p in parts]
                )
                ukind = _unify_kind({p.kind for p in parts})
                fkinds = None
                if ukind in ("Geometry", "GeometryCollection"):
                    # preserve per-feature kinds across the merge; a part
                    # with a concrete kind contributes uniform codes. A
                    # mixed-kind part LACKING feature_kinds (pre-round-2
                    # cached column) cannot be coded per feature — stamping
                    # code 6 would relabel its features as collections —
                    # so the merged column degrades to None (the
                    # representative-point density fallback) instead
                    if all(
                        p.feature_kinds is not None
                        or _kind_code(p.kind) != 6
                        for p in parts
                    ):
                        fkinds = np.concatenate(
                            [
                                p.feature_kinds
                                if p.feature_kinds is not None
                                else np.full(
                                    len(p), _kind_code(p.kind), np.int8
                                )
                                for p in parts
                            ]
                        )
                cols[name] = GeometryColumn(
                    ukind,
                    np.concatenate([p.x for p in parts]),
                    np.concatenate([p.y for p in parts]),
                    np.concatenate([p.vertices for p in parts]),
                    np.concatenate(
                        [[0]]
                        + [p.ring_offsets[1:] + v for p, v in zip(parts, voff)]
                    ).astype(np.int64),
                    np.concatenate(
                        [[0]]
                        + [p.feature_rings[1:] + r for p, r in zip(parts, roff)]
                    ).astype(np.int64),
                    list(
                        itertools.chain.from_iterable(
                            p.feature_parts for p in parts
                        )
                    ),
                    np.concatenate([p.bbox for p in parts]),
                    fkinds,
                )
            else:
                geoms = [p.geometry(i) for p in parts for i in range(len(p))]
                cols[name] = GeometryColumn.from_geometries(geoms)
        fids = None
        if batches[0].fids is not None:
            fids = DictColumn.concat([b.fids for b in batches])
        valid = None
        if any(b.valid is not None for b in batches):
            valid = np.concatenate(
                [
                    b.valid if b.valid is not None else np.ones(len(b), dtype=bool)
                    for b in batches
                ]
            )
        return FeatureBatch(sft, cols, fids, valid)

    # -- construction ------------------------------------------------------

    @classmethod
    def from_pydict(
        cls,
        sft: SimpleFeatureType,
        data: Dict[str, Sequence],
        fids: Optional[Sequence[str]] = None,
    ) -> "FeatureBatch":
        """Build from plain Python lists/arrays keyed by attribute name.

        Geometry attributes accept: a list of Geometry, a list of WKT strings,
        or (for Point) a (N,2) array / list of (x, y) tuples.
        """
        from geomesa_tpu_torch.core.wkt import parse_wkt

        cols: Dict[str, Column] = {}
        for attr in sft.attributes:
            if attr.name not in data:
                raise KeyError(f"missing column {attr.name!r}")
            raw = data[attr.name]
            if attr.is_geometry:
                if isinstance(raw, np.ndarray) and raw.ndim == 2:
                    cols[attr.name] = GeometryColumn.from_points(raw[:, 0], raw[:, 1])
                else:
                    raw = list(raw)
                    if raw and isinstance(raw[0], str):
                        raw = [parse_wkt(w) for w in raw]
                    if raw and isinstance(raw[0], (tuple, list)):
                        arr = np.asarray(raw, dtype=np.float64)
                        cols[attr.name] = GeometryColumn.from_points(arr[:, 0], arr[:, 1])
                    else:
                        cols[attr.name] = GeometryColumn.from_geometries(
                            raw, kind=attr.type
                        )
            elif attr.type in ("String", "UUID"):
                cols[attr.name] = DictColumn.encode(list(raw))
            elif attr.is_temporal:
                cols[attr.name] = _to_epoch_millis(raw)
            elif attr.type == "Bytes":
                cols[attr.name] = np.array(list(raw), dtype=object)
            elif attr.type.startswith(("List[", "Map[")):
                raise NotImplementedError(
                    f"columnar layout for {attr.type!r} not implemented yet"
                )
            else:
                dtype = {
                    "Integer": np.int32,
                    "Long": np.int64,
                    "Double": np.float64,
                    "Float": np.float32,
                    "Boolean": np.bool_,
                }[attr.type]
                cols[attr.name] = np.asarray(raw, dtype=dtype)
        fid_col = DictColumn.encode(list(fids)) if fids is not None else None
        return cls(sft, cols, fid_col)


def _to_epoch_millis(values) -> np.ndarray:
    arr = np.asarray(values)
    if arr.dtype.kind == "M":
        return arr.astype("datetime64[ms]").astype(np.int64)
    if arr.dtype.kind in "iu":
        return arr.astype(np.int64)
    if arr.dtype.kind == "f":
        return arr.astype(np.int64)
    # strings: ISO 8601
    return (
        np.array([np.datetime64(_clean_iso(str(v))) for v in values])
        .astype("datetime64[ms]")
        .astype(np.int64)
    )


def _clean_iso(s: str) -> str:
    s = s.strip()
    if s.endswith("Z"):
        s = s[:-1]
    return s
