"""Typed system properties with an environment-variable fallback.

A trimmed copy of the reference package's `utils/config.py`: the
`SystemProperty` class and the properties the port reads. A property
such as "geomesa.spatial.prep.cache.dir" maps to the environment variable
GEOMESA_TPU_SPATIAL_PREP_CACHE_DIR, as in the reference, so both packages
read the same setting.
"""

from __future__ import annotations

import dataclasses
import os
import threading
from typing import Callable, Dict, Optional


@dataclasses.dataclass
class SystemProperty:
    name: str  # dotted, e.g. "geomesa.spatial.prep.cache.dir"
    default: object
    parser: Callable[[str], object]
    description: str = ""

    @property
    def env_name(self) -> str:
        return self.name.upper().replace(".", "_").replace("GEOMESA_", "GEOMESA_TPU_", 1)

    def get(self) -> object:
        override = _overrides.get(self.name)
        if override is not None:
            return override
        raw = os.environ.get(self.env_name)
        if raw is not None:
            return self.parser(raw)
        return self.default

    @property
    def provenance(self) -> str:
        if self.name in _overrides:
            return "override"
        if self.env_name in os.environ:
            return f"env:{self.env_name}"
        return "default"


_overrides: Dict[str, object] = {}
_lock = threading.Lock()


class SystemProperties:
    """The properties the port reads."""

    SPATIAL_PREP_CACHE_DIR = SystemProperty(
        "geomesa.spatial.prep.cache.dir", "", str,
        "disk cache directory for polygon-layer prep structures (pair "
        "lists / padded edge tables — the prepared-geometry analog); "
        "empty = in-process cache only",
    )
    KNN_FULLSCAN_SELECTIVITY = SystemProperty(
        "geomesa.knn.fullscan.selectivity", 0.5, float,
        "kNN auto kernel choice: estimated filter selectivity at or above "
        "which the dense fullscan replaces the sparse tile scan (stats-"
        "driven StrategyDecider analog; sparse pruning cannot win when "
        "nearly every data tile bears a match)",
    )
    FORCE_COUNT = SystemProperty(
        "geomesa.force.count", False, lambda s: s.lower() in ("1", "true"),
        "exact counts by default (vs manifest estimates)",
    )
    COORD_DTYPE = SystemProperty(
        "geomesa.coord.dtype", "float32", str,
        "device coordinate dtype (float32|float64)",
    )
    SCAN_BLOCK_FULL_TABLE = SystemProperty(
        "geomesa.scan.block.full.table", False,
        lambda s: s.lower() in ("1", "true"),
        "reject queries whose filter constrains nothing (full-table scans)",
    )
    LOAD_INTERCEPTORS = SystemProperty(
        "geomesa.query.interceptors.load", False,
        lambda s: s.lower() in ("1", "true"),
        "allow dotted-path interceptor classes from SFT user_data to be "
        "imported and instantiated (schema metadata round-trips through "
        "converter configs and store manifests, so arbitrary-import is "
        "opt-in; the built-in 'full-table-scan-guard' always loads)",
    )
    QUERY_TIMEOUT_MS = SystemProperty(
        "geomesa.query.timeout", 0, int, "per-query timeout in ms; 0 = none"
    )
    SCAN_BATCH_SIZE = SystemProperty(
        "geomesa.scan.batch.size", 1 << 20, int,
        "target features per device batch on the scan path",
    )
    SCAN_RANGES_TARGET = SystemProperty(
        "geomesa.scan.ranges.target", 2000, int,
        "z-range decomposition budget (more ranges = tighter covering)",
    )
    SQL_JOIN_MAX_ROWS = SystemProperty(
        "geomesa.sql.join.max.rows", 1 << 25, int,
        "per-side row cap for SQL joins (the join itself is a host-side "
        "hash/kernel join over materialized sides; a silent 67M-row "
        "materialization would exhaust host memory — push filters into "
        "the WHERE clause or raise the cap deliberately)",
    )

    @staticmethod
    def set(name: str, value: object) -> None:
        with _lock:
            _overrides[name] = value

    @staticmethod
    def clear(name: Optional[str] = None) -> None:
        with _lock:
            if name is None:
                _overrides.clear()
            else:
                _overrides.pop(name, None)
