"""Minimal CRS registry + reprojection: a copy of the reference package's
`core/crs.py` (host f64 NumPy).

Parity role: the LocalQueryRunner's reprojection step (upstream
o.l.g.index.planning.LocalQueryRunner via GeoTools ReprojectingFeature-
Collection — SURVEY.md:219-220): a Query may request output in a CRS
other than the store's native one, applied as a finish step on result
geometries. Registered families, all closed-form and vectorized:
EPSG:4326 (lon/lat WGS84, the engine's native frame), EPSG:3857
(spherical web mercator), the UTM zone grid (326xx/327xx, 6th-order
Krueger), polar stereographic (3413/3031/3976, the NSIDC/Antarctic
frames) and LAEA Europe (3035) — the projected frames geospatial
analysts actually request; anything else raises. st_transform in the
SQL layer shares these functions.

All engine math (curves, predicates, kernels) stays in 4326; 3857 is an
OUTPUT (or input-normalization) frame only, matching how the reference
keeps indexing in a single CRS and reprojects at the edges.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import numpy as np

R_MAJOR = 6378137.0  # spherical mercator earth radius (EPSG:3857)
_MAX_LAT = 85.051128779806604  # atan(sinh(pi)) — 3857's latitude bound


def _ident(x, y):
    return np.asarray(x, np.float64), np.asarray(y, np.float64)


def _to_mercator(x, y):
    lon = np.asarray(x, np.float64)
    lat = np.clip(np.asarray(y, np.float64), -_MAX_LAT, _MAX_LAT)
    mx = np.radians(lon) * R_MAJOR
    my = R_MAJOR * np.log(np.tan(np.pi / 4.0 + np.radians(lat) / 2.0))
    return mx, my


def _from_mercator(x, y):
    mx = np.asarray(x, np.float64)
    my = np.asarray(y, np.float64)
    lon = np.degrees(mx / R_MAJOR)
    lat = np.degrees(2.0 * np.arctan(np.exp(my / R_MAJOR)) - np.pi / 2.0)
    return lon, lat


# --- UTM zone family ---------------------------------------------------------
# EPSG:326zz (north) / 327zz (south), zz = 01..60. Ellipsoidal transverse
# Mercator via the 6th-order Krueger flattening series (the formulation
# PROJ's `tmerc` approximates; in-zone error << 1 mm on WGS84). UTM is the
# most common analytic output frame after 3857 (upstream reprojection is
# any GeoTools CRS — SURVEY.md:219-220; this covers the projected family
# analysts actually request).

_WGS84_A = 6378137.0
_WGS84_F = 1.0 / 298.257223563
_UTM_K0 = 0.9996
_UTM_FE = 500_000.0
_UTM_FN_SOUTH = 10_000_000.0

_N = _WGS84_F / (2.0 - _WGS84_F)


def _series(coeffs):
    return np.array(coeffs, np.float64)


_n = _N
# rectifying radius and the alpha/beta/delta series in n (Krueger 1912,
# coefficients as tabulated by Deakin/Karney to n^6)
_A_RECT = _WGS84_A / (1 + _n) * (
    1 + _n**2 / 4 + _n**4 / 64 + _n**6 / 256)
_ALPHA = _series([
    _n / 2 - 2 * _n**2 / 3 + 5 * _n**3 / 16 + 41 * _n**4 / 180
    - 127 * _n**5 / 288 + 7891 * _n**6 / 37800,
    13 * _n**2 / 48 - 3 * _n**3 / 5 + 557 * _n**4 / 1440
    + 281 * _n**5 / 630 - 1983433 * _n**6 / 1935360,
    61 * _n**3 / 240 - 103 * _n**4 / 140 + 15061 * _n**5 / 26880
    + 167603 * _n**6 / 181440,
    49561 * _n**4 / 161280 - 179 * _n**5 / 168 + 6601661 * _n**6 / 7257600,
    34729 * _n**5 / 80640 - 3418889 * _n**6 / 1995840,
    212378941 * _n**6 / 319334400,
])
_BETA = _series([
    _n / 2 - 2 * _n**2 / 3 + 37 * _n**3 / 96 - _n**4 / 360
    - 81 * _n**5 / 512 + 96199 * _n**6 / 604800,
    _n**2 / 48 + _n**3 / 15 - 437 * _n**4 / 1440 + 46 * _n**5 / 105
    - 1118711 * _n**6 / 3870720,
    17 * _n**3 / 480 - 37 * _n**4 / 840 - 209 * _n**5 / 4480
    + 5569 * _n**6 / 90720,
    4397 * _n**4 / 161280 - 11 * _n**5 / 504 - 830251 * _n**6 / 7257600,
    4583 * _n**5 / 161280 - 108847 * _n**6 / 3991680,
    20648693 * _n**6 / 638668800,
])
_DELTA = _series([
    2 * _n - 2 * _n**2 / 3 - 2 * _n**3 + 116 * _n**4 / 45
    + 26 * _n**5 / 45 - 2854 * _n**6 / 675,
    7 * _n**2 / 3 - 8 * _n**3 / 5 - 227 * _n**4 / 45 + 2704 * _n**5 / 315
    + 2323 * _n**6 / 945,
    56 * _n**3 / 15 - 136 * _n**4 / 35 - 1262 * _n**5 / 105
    + 73814 * _n**6 / 2835,
    4279 * _n**4 / 630 - 332 * _n**5 / 35 - 399572 * _n**6 / 14175,
    4174 * _n**5 / 315 - 144838 * _n**6 / 6237,
    601676 * _n**6 / 22275,
])
_E2N = 2.0 * np.sqrt(_N) / (1.0 + _N)  # 2*sqrt(n)/(1+n), conformal-lat term


def utm_zone_srid(lon: float, lat: float) -> int:
    """The canonical UTM zone EPSG code for a lon/lat (the zone picker a
    CLI/analyst uses; Norway/Svalbard exceptions intentionally omitted —
    they are cartographic conventions, not math)."""
    zone = int(np.clip((np.floor((lon + 180.0) / 6.0) + 1), 1, 60))
    return (32600 if lat >= 0 else 32700) + zone


def _utm_params(srid: int):
    srid = int(srid)
    if 32601 <= srid <= 32660:
        zone, south = srid - 32600, False
    elif 32701 <= srid <= 32760:
        zone, south = srid - 32700, True
    else:
        return None
    lon0 = -183.0 + 6.0 * zone
    return lon0, (_UTM_FN_SOUTH if south else 0.0)


def _to_utm(x, y, lon0: float, fn: float):
    lon = np.asarray(x, np.float64)
    lat = np.asarray(y, np.float64)
    phi = np.radians(lat)
    dlam = np.radians(lon - lon0)
    s = np.sin(phi)
    # conformal latitude tau' (Karney form, numerically stable)
    t = np.sinh(np.arctanh(s) - _E2N * np.arctanh(_E2N * s))
    xi_p = np.arctan2(t, np.cos(dlam))
    eta_p = np.arcsinh(np.sin(dlam) / np.hypot(t, np.cos(dlam)))
    xi = xi_p.copy()
    eta = eta_p.copy()
    for j in range(6):
        w = 2.0 * (j + 1)
        xi += _ALPHA[j] * np.sin(w * xi_p) * np.cosh(w * eta_p)
        eta += _ALPHA[j] * np.cos(w * xi_p) * np.sinh(w * eta_p)
    return (_UTM_FE + _UTM_K0 * _A_RECT * eta,
            fn + _UTM_K0 * _A_RECT * xi)


def _from_utm(x, y, lon0: float, fn: float):
    e = np.asarray(x, np.float64)
    nn = np.asarray(y, np.float64)
    xi = (nn - fn) / (_UTM_K0 * _A_RECT)
    eta = (e - _UTM_FE) / (_UTM_K0 * _A_RECT)
    xi_p = xi.copy()
    eta_p = eta.copy()
    for j in range(6):
        w = 2.0 * (j + 1)
        xi_p -= _BETA[j] * np.sin(w * xi) * np.cosh(w * eta)
        eta_p -= _BETA[j] * np.cos(w * xi) * np.sinh(w * eta)
    chi = np.arcsin(np.sin(xi_p) / np.cosh(eta_p))  # conformal latitude
    phi = chi.copy()
    for j in range(6):
        w = 2.0 * (j + 1)
        phi += _DELTA[j] * np.sin(w * chi)
    dlam = np.arctan2(np.sinh(eta_p), np.cos(xi_p))
    return lon0 + np.degrees(dlam), np.degrees(phi)


# --- polar stereographic family --------------------------------------------
# EPSG 9829 (variant B, standard-parallel form), Snyder 21-32..21-41:
# the NSIDC / Antarctic analytic frames. Registered: 3413 (NSIDC Arctic,
# lat_ts 70N, lon0 -45), 3031 (Antarctic, lat_ts 71S, lon0 0), 3976
# (NSIDC Sea Ice South, lat_ts 70S, lon0 0). All WGS84, FE = FN = 0.

_E = np.sqrt(_WGS84_F * (2.0 - _WGS84_F))  # first eccentricity

# srid -> (lon0_deg, lat_ts_deg, south)
_POLAR: Dict[int, Tuple[float, float, bool]] = {
    3413: (-45.0, 70.0, False),
    3031: (0.0, -71.0, True),
    3976: (0.0, -70.0, True),
}


def _ps_t(phi):
    """Snyder 15-9: the isometric-colatitude parameter t."""
    s = _E * np.sin(phi)
    return (np.tan(np.pi / 4.0 - phi / 2.0)
            / ((1.0 - s) / (1.0 + s)) ** (_E / 2.0))


def _to_polar(x, y, lon0: float, lat_ts: float, south: bool):
    lon = np.asarray(x, np.float64)
    lat = np.asarray(y, np.float64)
    if south:  # solve on the north-polar form with mirrored latitude
        lat = -lat
        lon = -lon
        lon0 = -lon0
    phi = np.radians(lat)
    phi_c = np.radians(abs(lat_ts))
    mc = np.cos(phi_c) / np.sqrt(1.0 - (_E * np.sin(phi_c)) ** 2)
    rho = _WGS84_A * mc * _ps_t(phi) / _ps_t(phi_c)
    dlam = np.radians(lon - lon0)
    ex = rho * np.sin(dlam)
    ny = -rho * np.cos(dlam)
    if south:
        ex, ny = -ex, -ny
    return ex, ny


def _from_polar(x, y, lon0: float, lat_ts: float, south: bool):
    ex = np.asarray(x, np.float64)
    ny = np.asarray(y, np.float64)
    if south:
        ex, ny = -ex, -ny
        lon0 = -lon0
    phi_c = np.radians(abs(lat_ts))
    mc = np.cos(phi_c) / np.sqrt(1.0 - (_E * np.sin(phi_c)) ** 2)
    rho = np.hypot(ex, ny)
    t = rho * _ps_t(phi_c) / (_WGS84_A * mc)
    phi = np.pi / 2.0 - 2.0 * np.arctan(t)
    for _ in range(6):  # Snyder 7-9 fixed point; quadratic convergence
        s = _E * np.sin(phi)
        phi = (np.pi / 2.0
               - 2.0 * np.arctan(t * ((1.0 - s) / (1.0 + s)) ** (_E / 2.0)))
    dlam = np.arctan2(ex, -ny)
    lon = lon0 + np.degrees(dlam)
    lat = np.degrees(phi)
    if south:
        lon, lat = -lon, -lat
    # lon0 offsets push lon outside [-180,180] (3413's lon0=-45 yields
    # (-225,135]); downstream consumers (bbox predicates, Z-curve keys,
    # chained transforms) assume the canonical branch
    lon = (lon + 180.0) % 360.0 - 180.0
    return lon, lat


# --- Lambert azimuthal equal-area: EPSG 3035 (ETRS89-extended / LAEA
# Europe; treated as WGS84 — the datums agree to <1 m) ----------------------
# Snyder 24-2..24-16 with authalic latitudes; the statistical-analysis
# frame for pan-European grids.

_LAEA: Dict[int, Tuple[float, float, float, float]] = {
    # srid -> (lon0, lat0, false easting, false northing)
    3035: (10.0, 52.0, 4_321_000.0, 3_210_000.0),
}
_E2 = _E * _E


def _laea_q(phi):
    s = np.sin(phi)
    es = _E * s
    return (1.0 - _E2) * (
        s / (1.0 - _E2 * s * s)
        - np.log((1.0 - es) / (1.0 + es)) / (2.0 * _E)
    )


_QP = _laea_q(np.pi / 2.0)
_RQ = _WGS84_A * np.sqrt(_QP / 2.0)
# authalic -> geodetic series coefficients (Snyder 3-18)
_AUTH = (
    _E2 / 3.0 + 31.0 * _E2**2 / 180.0 + 517.0 * _E2**3 / 5040.0,
    23.0 * _E2**2 / 360.0 + 251.0 * _E2**3 / 3780.0,
    761.0 * _E2**3 / 45360.0,
)


def _to_laea(x, y, lon0: float, lat0: float, fe: float, fn: float):
    lon = np.asarray(x, np.float64)
    lat = np.asarray(y, np.float64)
    phi = np.radians(lat)
    lam0 = np.radians(lon0)
    phi0 = np.radians(lat0)
    beta = np.arcsin(np.clip(_laea_q(phi) / _QP, -1.0, 1.0))
    beta0 = np.arcsin(np.clip(_laea_q(phi0) / _QP, -1.0, 1.0))
    m0 = np.cos(phi0) / np.sqrt(1.0 - (_E * np.sin(phi0)) ** 2)
    d = _WGS84_A * m0 / (_RQ * np.cos(beta0))
    dlam = np.radians(lon) - lam0
    denom = 1.0 + (np.sin(beta0) * np.sin(beta)
                   + np.cos(beta0) * np.cos(beta) * np.cos(dlam))
    b = _RQ * np.sqrt(2.0 / denom)
    ex = fe + b * d * np.cos(beta) * np.sin(dlam)
    ny = fn + (b / d) * (np.cos(beta0) * np.sin(beta)
                         - np.sin(beta0) * np.cos(beta) * np.cos(dlam))
    return ex, ny


def _from_laea(x, y, lon0: float, lat0: float, fe: float, fn: float):
    ex = np.asarray(x, np.float64) - fe
    ny = np.asarray(y, np.float64) - fn
    phi0 = np.radians(lat0)
    beta0 = np.arcsin(np.clip(_laea_q(phi0) / _QP, -1.0, 1.0))
    m0 = np.cos(phi0) / np.sqrt(1.0 - (_E * np.sin(phi0)) ** 2)
    d = _WGS84_A * m0 / (_RQ * np.cos(beta0))
    rho = np.hypot(ex / d, d * ny)
    ce = 2.0 * np.arcsin(np.clip(rho / (2.0 * _RQ), -1.0, 1.0))
    with np.errstate(invalid="ignore", divide="ignore"):
        beta = np.where(
            rho == 0.0, beta0,
            np.arcsin(np.clip(
                np.cos(ce) * np.sin(beta0)
                + (d * ny * np.sin(ce) * np.cos(beta0)) / np.where(
                    rho == 0.0, 1.0, rho), -1.0, 1.0)),
        )
        dlam = np.arctan2(
            (ex / d) * np.sin(ce),
            rho * np.cos(beta0) * np.cos(ce)
            - d * ny * np.sin(beta0) * np.sin(ce),
        )
        dlam = np.where(rho == 0.0, 0.0, dlam)
    phi = beta + (_AUTH[0] * np.sin(2.0 * beta)
                  + _AUTH[1] * np.sin(4.0 * beta)
                  + _AUTH[2] * np.sin(6.0 * beta))
    # the 3-term authalic series leaves ~1e-8 deg (~1.3 mm); two Newton
    # steps on q(phi) = q (Snyder 3-16) converge to f64 round-trip
    q = _QP * np.sin(beta)
    for _ in range(2):
        s = np.sin(phi)
        es = _E * s
        w2 = 1.0 - _E2 * s * s
        phi = phi + (w2 ** 2 / (2.0 * np.cos(phi))) * (
            q / (1.0 - _E2) - s / w2
            + np.log((1.0 - es) / (1.0 + es)) / (2.0 * _E)
        )
    return lon0 + np.degrees(dlam), np.degrees(phi)


def supported(from_srid: int, to_srid: int) -> bool:
    return _lookup(int(from_srid), int(to_srid)) is not None


def _proj_pair(srid: int):
    """(to_from_4326, from_to_4326) for any registered projected CRS —
    spherical mercator, the UTM zone grid, polar stereographic, LAEA —
    or None. Every projected<->projected route goes through 4326 (the
    native frame, exactly invertible at f64)."""
    pu = _utm_params(srid)
    if pu is not None:
        return (lambda lx, ly: _to_utm(lx, ly, *pu),
                lambda ex, ey: _from_utm(ex, ey, *pu))
    if srid == 3857:
        return _to_mercator, _from_mercator
    pp = _POLAR.get(srid)
    if pp is not None:
        return (lambda lx, ly: _to_polar(lx, ly, *pp),
                lambda ex, ey: _from_polar(ex, ey, *pp))
    pq = _LAEA.get(srid)
    if pq is not None:
        return (lambda lx, ly: _to_laea(lx, ly, *pq),
                lambda ex, ey: _from_laea(ex, ey, *pq))
    return None


def _lookup(src: int, dst: int):
    if src == dst:
        # same-CRS no-op must be EXACT pass-through, not a lossy
        # round trip through 4326
        return _ident if (src == 4326 or _proj_pair(src)) else None
    if src == 4326:
        p = _proj_pair(dst)
        return p[0] if p else None
    if dst == 4326:
        p = _proj_pair(src)
        return p[1] if p else None
    ps, pd = _proj_pair(src), _proj_pair(dst)
    if ps is not None and pd is not None:
        return lambda ex, ey: pd[0](*ps[1](ex, ey))
    return None


def transform(x, y, from_srid: int, to_srid: int):
    """Vectorized coordinate transform. Raises ValueError on an
    unregistered CRS pair (same contract as an unknown EPSG code in the
    reference's referencing factory)."""
    key = (int(from_srid), int(to_srid))
    fn = _lookup(*key)
    if fn is None:
        raise ValueError(
            f"unsupported CRS transform EPSG:{key[0]} -> EPSG:{key[1]} "
            "(registered: 4326, 3857, UTM 326xx/327xx, polar "
            "3413/3031/3976, LAEA 3035)"
        )
    return fn(x, y)


def reproject_batch(batch, to_srid: int):
    """Return a FeatureBatch with every geometry column transformed from
    its attribute srid (default 4326) to `to_srid`; attribute options are
    updated so the result self-describes its CRS. No-op (same object)
    when every geometry is already in `to_srid`."""
    import dataclasses

    from geomesa_tpu_torch.core.columnar import FeatureBatch, GeometryColumn
    from geomesa_tpu_torch.core.sft import SimpleFeatureType

    changed = False
    cols = dict(batch.columns)
    attrs = []
    for a in batch.sft.attributes:
        if not a.is_geometry:
            attrs.append(a)
            continue
        src = int(a.options.get("srid", 4326))
        if src == int(to_srid):
            attrs.append(a)
            continue
        changed = True
        col = cols[a.name]
        if col.is_point:
            nx, ny = transform(col.x, col.y, src, to_srid)
            cols[a.name] = GeometryColumn(col.kind, nx, ny)
        else:
            vx, vy = transform(
                col.vertices[:, 0], col.vertices[:, 1], src, to_srid)
            bx0, by0 = transform(col.bbox[:, 0], col.bbox[:, 1], src, to_srid)
            bx1, by1 = transform(col.bbox[:, 2], col.bbox[:, 3], src, to_srid)
            cx, cy = transform(col.x, col.y, src, to_srid)
            cols[a.name] = GeometryColumn(
                col.kind, cx, cy,
                np.stack([vx, vy], 1), col.ring_offsets,
                col.feature_rings, col.feature_parts,
                np.stack([bx0, by0, bx1, by1], 1),
                # mixed-kind columns keep their per-feature kind codes —
                # dropping them re-types every feature to the column kind
                col.feature_kinds,
            )
        opts = dict(a.options)
        opts["srid"] = str(int(to_srid))
        attrs.append(dataclasses.replace(a, options=opts))
    if not changed:
        return batch
    sft = SimpleFeatureType(batch.sft.name, attrs, batch.sft.user_data)
    return FeatureBatch(sft, cols, batch.fids, batch.valid)
