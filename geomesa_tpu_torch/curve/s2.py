"""S2-style cube-face space-filling curve.

A copy of the reference package's `curve/s2.py` (host NumPy): the
key-value store's S2 index.

Parity role: the reference's S2 index variant (geomesa-index-api s2/s3
keyspaces backed by the sidx S2 library — SURVEY.md:241-242 [L], deferred
in rounds 1-2, built here). Design follows Google S2's projection chain:

  lon/lat -> unit vector -> cube FACE (max-|axis|) -> face (u, v) by
  central projection -> quadratic (s, t) reprojection (S2's area-
  equalizing transform: cell areas vary ~2.1x instead of the raw cube
  projection's ~5.2x) -> discrete (si, ti) at `level`.

Intra-face ordering is Morton/Z (NOT S2's Hilbert): the locality
properties the planner needs (contiguous ranges cover contiguous regions)
hold for either order, the repo already has exact Z BIGMIN-style range
machinery, and Hilbert buys ~10-20% fewer ranges at equal budget — noted
trade. Cell ids are therefore NOT interoperable with Google S2 ids; this
is an S2-STYLE keyspace, not an S2 binding (none is possible: zero-dep
environment).

Why a cube-face curve at all (vs Z2): no polar singularity — Z2 cells
degenerate in area toward the poles (lon compression), while cube faces
bound the distortion, so high-latitude workloads (AIS!) get uniform
per-cell selectivity and ~constant-size covering ranges.

Covering construction: BFS quadtree refinement over (face, s, t) cells.
Each cell's lon/lat bounds come from its corners with conservative
handling of the two non-monotone cases (pole-containing cells on the top/
bottom faces; antimeridian-spanning cells) plus a curvature pad — the
covering tests assert the union of ranges contains every in-box point's
cell id over randomized boxes (the same guarantee contract as zranges).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from geomesa_tpu_torch.curve.zranges import IndexRange, _merge
from geomesa_tpu_torch.curve.zorder import deinterleave2, interleave2

MAX_LEVEL = 30


def _uv_to_st(u):
    """S2 quadratic projection, vectorized. Both np.where branches are
    evaluated for every lane, so each sqrt argument is clamped at 0 —
    the unclamped form emitted RuntimeWarning NaNs on the unselected
    branch (u outside [-1/3, 1/3] in exactly one of them)."""
    u = np.asarray(u, np.float64)
    return np.where(
        u >= 0, 0.5 * np.sqrt(np.maximum(1.0 + 3.0 * u, 0.0)),
        1.0 - 0.5 * np.sqrt(np.maximum(1.0 - 3.0 * u, 0.0)),
    )


def _st_to_uv(s):
    s = np.asarray(s, np.float64)
    return np.where(
        s >= 0.5, (1.0 / 3.0) * (4.0 * s * s - 1.0),
        (1.0 / 3.0) * (1.0 - 4.0 * (1.0 - s) * (1.0 - s)),
    )


# face frames: normal N, tangents E1/E2 (u = p.E1/p.N, v = p.E2/p.N).
# Any orthogonal frame per face works — index/invert just must agree;
# these differ from Google S2's frames (ids are not interoperable anyway).
_N = np.array([[1, 0, 0], [0, 1, 0], [0, 0, 1],
               [-1, 0, 0], [0, -1, 0], [0, 0, -1]], np.float64)
_E1 = np.array([[0, 1, 0], [-1, 0, 0], [-1, 0, 0],
                [0, -1, 0], [1, 0, 0], [1, 0, 0]], np.float64)
_E2 = np.array([[0, 0, 1], [0, 0, 1], [0, -1, 0],
                [0, 0, 1], [0, 0, 1], [0, 1, 0]], np.float64)


def lonlat_to_face_st(lon, lat):
    """Vectorized (lon, lat) degrees -> (face [0..5], s, t)."""
    rlon = np.radians(np.asarray(lon, np.float64))
    rlat = np.radians(np.asarray(lat, np.float64))
    p = np.stack([np.cos(rlat) * np.cos(rlon),
                  np.cos(rlat) * np.sin(rlon),
                  np.sin(rlat)], -1)  # [..., 3]
    dots = p @ _N.T  # [..., 6]
    face = np.argmax(dots, axis=-1).astype(np.int64)
    denom = np.take_along_axis(dots, face[..., None], axis=-1)[..., 0]
    u = np.einsum("...k,...k->...", p, _E1[face]) / denom
    v = np.einsum("...k,...k->...", p, _E2[face]) / denom
    return face, _uv_to_st(u), _uv_to_st(v)


def face_st_to_lonlat(face, s, t):
    """Vectorized (face, s, t) -> (lon, lat) degrees."""
    face = np.asarray(face, np.int64)
    u = _st_to_uv(np.asarray(s, np.float64))
    v = _st_to_uv(np.asarray(t, np.float64))
    p = _N[face] + u[..., None] * _E1[face] + v[..., None] * _E2[face]
    lon = np.degrees(np.arctan2(p[..., 1], p[..., 0]))
    lat = np.degrees(np.arctan2(p[..., 2], np.hypot(p[..., 0], p[..., 1])))
    return lon, lat


class S2SFC:
    """Cube-face curve at a fixed level: cellid = face * 4^level + Z(si, ti)."""

    def __init__(self, level: int = 15):
        assert 1 <= level <= MAX_LEVEL
        self.level = level
        self.dim = 1 << level  # cells per face edge

    def index(self, lon, lat) -> np.ndarray:
        face, s, t = lonlat_to_face_st(lon, lat)
        si = np.clip((s * self.dim).astype(np.int64), 0, self.dim - 1)
        ti = np.clip((t * self.dim).astype(np.int64), 0, self.dim - 1)
        z = interleave2(si.astype(np.uint64), ti.astype(np.uint64))
        return face * (1 << (2 * self.level)) + np.asarray(z, np.int64)

    def invert(self, cellid) -> Tuple[np.ndarray, np.ndarray]:
        cellid = np.asarray(cellid, np.int64)
        per_face = 1 << (2 * self.level)
        face = cellid // per_face
        si, ti = deinterleave2(np.asarray(cellid % per_face, np.uint64))
        s = (np.asarray(si, np.float64) + 0.5) / self.dim
        t = (np.asarray(ti, np.float64) + 0.5) / self.dim
        return face_st_to_lonlat(face, s, t)

    # -- covering ------------------------------------------------------------

    def _cell_lonlat_bounds(self, face, s0, t0, s1, t1):
        """Conservative lon/lat bbox of one (face, st-rect) cell."""
        corners_s = np.array([s0, s1, s0, s1, (s0 + s1) / 2])
        corners_t = np.array([t0, t0, t1, t1, (t0 + t1) / 2])
        lon, lat = face_st_to_lonlat(
            np.full(5, face), corners_s, corners_t
        )
        lat_lo, lat_hi = float(lat.min()), float(lat.max())
        lon_lo, lon_hi = float(lon.min()), float(lon.max())
        # pole-containing cells: lat extreme is interior, lon spans all
        if face in (2, 5) and s0 <= 0.5 <= s1 and t0 <= 0.5 <= t1:
            if face == 2:
                lat_hi = 90.0
            else:
                lat_lo = -90.0
            lon_lo, lon_hi = -180.0, 180.0
        # antimeridian-spanning cells: corner-lon spread is meaningless
        if lon_hi - lon_lo > 180.0:
            lon_lo, lon_hi = -180.0, 180.0
        # curvature pad: cell edges bow relative to the corner hull
        pad = 0.55 * max(s1 - s0, t1 - t0) * 90.0 * 0.5 + 1e-9
        return (lon_lo - pad, max(lat_lo - pad, -90.0),
                lon_hi + pad, min(lat_hi + pad, 90.0))

    def ranges(
        self, xmin: float, ymin: float, xmax: float, ymax: float,
        max_ranges: int = 512,
    ) -> List[IndexRange]:
        """Covering cellid ranges for a lon/lat box (BFS refinement)."""

        def intersects(b):
            lo_x, lo_y, hi_x, hi_y = b
            return not (hi_x < xmin or lo_x > xmax
                        or hi_y < ymin or lo_y > ymax)

        def contained(b):
            lo_x, lo_y, hi_x, hi_y = b
            return (lo_x >= xmin and hi_x <= xmax
                    and lo_y >= ymin and hi_y <= ymax)

        out: List[IndexRange] = []
        frontier = [(f, 0, 0.0, 0.0, 1.0, 1.0) for f in range(6)]
        L = self.level
        per_face = 1 << (2 * L)

        def emit(face, lvl, s0, t0, is_contained):
            si = int(s0 * self.dim)
            ti = int(t0 * self.dim)
            z = int(interleave2(
                np.asarray([si], np.uint64), np.asarray([ti], np.uint64)
            )[0])
            span = 1 << (2 * (L - lvl))
            # align the prefix: the cell's id block starts at the z of its
            # lowest corner rounded down to the block
            lo = face * per_face + (z // span) * span
            out.append(IndexRange(lo, lo + span - 1, is_contained))

        while frontier:
            face, lvl, s0, t0, s1, t1 = frontier.pop(0)
            b = self._cell_lonlat_bounds(face, s0, t0, s1, t1)
            if not intersects(b):
                continue
            if contained(b):
                emit(face, lvl, s0, t0, True)
                continue
            if lvl >= L or len(out) + len(frontier) >= max_ranges:
                emit(face, lvl, s0, t0, False)
                continue
            sm = (s0 + s1) / 2
            tm = (t0 + t1) / 2
            frontier.extend([
                (face, lvl + 1, s0, t0, sm, tm),
                (face, lvl + 1, sm, t0, s1, tm),
                (face, lvl + 1, s0, tm, sm, t1),
                (face, lvl + 1, sm, tm, s1, t1),
            ])
        return _merge(out)
