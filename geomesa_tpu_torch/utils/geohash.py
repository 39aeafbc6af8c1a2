"""GeoHash encode/decode (base-32 interleaved lat/lon prefix codes).

Parity: geomesa-utils o.l.g.utils.geohash.GeoHash [upstream, unverified].
Vectorized NumPy encode for columnar batches; scalar decode/neighbors for
host-side tiling. A GeoHash is the classic public algorithm: alternate
longitude/latitude bisection bits, grouped 5 at a time into the base-32
alphabet.

A copy of the reference package's `utils/geohash.py`.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

BASE32 = "0123456789bcdefghjkmnpqrstuvwxyz"
_DECODE = {c: i for i, c in enumerate(BASE32)}


def encode(lon, lat, precision: int = 9):
    """Vectorized: (lon[N], lat[N]) -> array of N geohash strings."""
    lon = np.atleast_1d(np.asarray(lon, dtype=np.float64))
    lat = np.atleast_1d(np.asarray(lat, dtype=np.float64))
    nbits = precision * 5
    lon_bits = (nbits + 1) // 2
    lat_bits = nbits // 2
    # normalize into integer grids
    li = np.clip(((lon + 180.0) / 360.0) * (1 << lon_bits), 0, (1 << lon_bits) - 1).astype(np.uint64)
    la = np.clip(((lat + 90.0) / 180.0) * (1 << lat_bits), 0, (1 << lat_bits) - 1).astype(np.uint64)
    # interleave: even bit positions (from MSB) are lon, odd are lat
    bits = np.zeros((len(lon), nbits), dtype=np.uint8)
    for b in range(lon_bits):
        bits[:, 2 * b] = (li >> np.uint64(lon_bits - 1 - b)) & np.uint64(1)
    for b in range(lat_bits):
        bits[:, 2 * b + 1] = (la >> np.uint64(lat_bits - 1 - b)) & np.uint64(1)
    out = []
    for row in bits:
        chars = []
        for g in range(precision):
            v = 0
            for bit in row[g * 5 : g * 5 + 5]:
                v = (v << 1) | int(bit)
            chars.append(BASE32[v])
        out.append("".join(chars))
    return np.asarray(out)


def encode_one(lon: float, lat: float, precision: int = 9) -> str:
    return str(encode([lon], [lat], precision)[0])


def decode_bbox(gh: str) -> Tuple[float, float, float, float]:
    """(xmin, ymin, xmax, ymax) of the geohash cell."""
    lon_lo, lon_hi = -180.0, 180.0
    lat_lo, lat_hi = -90.0, 90.0
    even = True  # lon first
    for c in gh:
        v = _DECODE[c]
        for shift in range(4, -1, -1):
            bit = (v >> shift) & 1
            if even:
                mid = (lon_lo + lon_hi) / 2.0
                if bit:
                    lon_lo = mid
                else:
                    lon_hi = mid
            else:
                mid = (lat_lo + lat_hi) / 2.0
                if bit:
                    lat_lo = mid
                else:
                    lat_hi = mid
            even = not even
    return (lon_lo, lat_lo, lon_hi, lat_hi)


def decode(gh: str) -> Tuple[float, float]:
    """Cell-center (lon, lat)."""
    xmin, ymin, xmax, ymax = decode_bbox(gh)
    return ((xmin + xmax) / 2.0, (ymin + ymax) / 2.0)


def neighbors(gh: str) -> List[str]:
    """The 8 surrounding cells at the same precision (clipped at poles)."""
    xmin, ymin, xmax, ymax = decode_bbox(gh)
    w = xmax - xmin
    h = ymax - ymin
    cx = (xmin + xmax) / 2.0
    cy = (ymin + ymax) / 2.0
    out = []
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dx == 0 and dy == 0:
                continue
            lon = cx + dx * w
            lat = cy + dy * h
            if lat <= -90.0 or lat >= 90.0:
                continue
            if lon < -180.0:
                lon += 360.0
            elif lon > 180.0:
                lon -= 360.0
            out.append(encode_one(lon, lat, len(gh)))
    return sorted(set(out) - {gh})


def bboxes_for(bbox: Tuple[float, float, float, float], precision: int) -> List[str]:
    """All geohash cells at `precision` overlapping bbox (host tiling aid)."""
    xmin, ymin, xmax, ymax = bbox
    x0, y0, x1, y1 = decode_bbox(encode_one(xmin, ymin, precision))
    w = x1 - x0
    h = y1 - y0
    out = []
    lat = y0 + h / 2.0
    while lat < ymax + h:
        lon = x0 + w / 2.0
        while lon < xmax + w:
            cell = encode_one(min(max(lon, -180.0), 180.0), min(max(lat, -90.0), 90.0), precision)
            cb = decode_bbox(cell)
            if cb[0] <= xmax and cb[2] >= xmin and cb[1] <= ymax and cb[3] >= ymin:
                out.append(cell)
            lon += w
        lat += h
    return sorted(set(out))
