"""Columnar feature batches (host side).

A copy of the reference package's `core/columnar.py` restricted to what
this slice of the port needs: dictionary-encoded string columns, POINT
geometry columns (x[N], y[N] f64) and the immutable `FeatureBatch` with
`from_pydict`, `concat`, `select` and `pad_to`. Extended geometries (the
CSR layout) come with the geometry slice and raise `NotPortedError`.

Padding carries a validity mask so fixed-shape device kernels can AND it
into predicate masks.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Union

import numpy as np

from geomesa_tpu_torch.core.sft import SimpleFeatureType
from geomesa_tpu_torch.core.wkt import Geometry
from geomesa_tpu_torch.errors import NotPortedError

_GEOMETRY_SLICE = "the extended-geometry slice (ROADMAP Queue A)"


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
        remaps (first-appearance order, as the reference)."""
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
class GeometryColumn:
    """Point geometry column: x[N], y[N] (f64)."""

    kind: str
    x: np.ndarray
    y: np.ndarray

    def __len__(self) -> int:
        return len(self.x)

    @property
    def is_point(self) -> bool:
        return True

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
        kinds = {g.kind for g in geoms} or ({kind} if kind else set())
        if not kinds <= {"Point"}:
            raise NotPortedError(f"{sorted(kinds)} geometry columns",
                                 _GEOMETRY_SLICE)
        xy = np.array([g.point for g in geoms], dtype=np.float64).reshape(-1, 2)
        return cls.from_points(xy[:, 0], xy[:, 1])

    def take(self, idx) -> "GeometryColumn":
        idx = np.asarray(idx)
        return GeometryColumn(self.kind, self.x[idx], self.y[idx])


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
                    np.concatenate([col.codes, np.full(pad, -1, np.int32)]),
                    col.vocab,
                )
            else:
                cols[name] = GeometryColumn(
                    col.kind,
                    np.concatenate([col.x, np.zeros(pad)]),
                    np.concatenate([col.y, np.zeros(pad)]),
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
            else:
                cols[name] = GeometryColumn.from_points(
                    np.concatenate([p.x for p in parts]),
                    np.concatenate([p.y for p in parts]),
                )
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

    @classmethod
    def from_pydict(
        cls,
        sft: SimpleFeatureType,
        data: Dict[str, Sequence],
        fids: Optional[Sequence[str]] = None,
    ) -> "FeatureBatch":
        """Build from plain Python lists/arrays keyed by attribute name.

        Point geometry attributes accept a list of Geometry, a list of WKT
        strings, a (N,2) array or a list of (x, y) tuples.
        """
        from geomesa_tpu_torch.core.wkt import parse_wkt

        cols: Dict[str, Column] = {}
        for attr in sft.attributes:
            if attr.name not in data:
                raise KeyError(f"missing column {attr.name!r}")
            raw = data[attr.name]
            if attr.is_geometry:
                if attr.type != "Point":
                    raise NotPortedError(f"{attr.type} geometry columns",
                                         _GEOMETRY_SLICE)
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
