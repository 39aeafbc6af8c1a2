"""Typed filter AST nodes.

Parity: the filter model of the GeoTools/OGC filter API as used by
geomesa-filter [upstream, unverified], reduced to plain dataclasses. Nodes
compare by value and are immutable; they are NOT hashable (Geometry holds
ndarrays) — key caches by `to_cql(f)` instead.

A copy of the reference package's `cql/ast.py`.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple, Union

from geomesa_tpu_torch.core.wkt import Geometry

# -- leaves ----------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Property:
    name: str


@dataclasses.dataclass(frozen=True)
class Literal:
    value: object  # float | int | str | bool | int-millis for datetimes
    kind: str = "scalar"  # scalar | datetime


Expr = Union[Property, Literal]

# -- predicates ------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Comparison:
    """op in {'=', '<>', '<', '<=', '>', '>='}"""

    op: str
    left: Expr
    right: Expr


@dataclasses.dataclass(frozen=True)
class Between:
    prop: Property
    lo: Literal
    hi: Literal
    negate: bool = False


@dataclasses.dataclass(frozen=True)
class Like:
    prop: Property
    pattern: str
    case_insensitive: bool = False
    negate: bool = False


@dataclasses.dataclass(frozen=True)
class In:
    prop: Property
    values: Tuple[object, ...]
    negate: bool = False


@dataclasses.dataclass(frozen=True)
class IsNull:
    prop: Property
    negate: bool = False


@dataclasses.dataclass(frozen=True)
class SpatialPredicate:
    """op in {'BBOX','INTERSECTS','WITHIN','CONTAINS','OVERLAPS','CROSSES',
    'TOUCHES','DISJOINT','EQUALS'}; geometry is the literal operand."""

    op: str
    prop: Property
    geometry: Geometry


@dataclasses.dataclass(frozen=True)
class DistancePredicate:
    """op in {'DWITHIN', 'BEYOND'}; distance converted to meters."""

    op: str
    prop: Property
    geometry: Geometry
    distance_m: float


@dataclasses.dataclass(frozen=True)
class TemporalPredicate:
    """op in {'DURING','BEFORE','AFTER','TEQUALS'}.

    For DURING, (start, end) epoch-millis; others use start only.
    DURING follows the strict-interior semantics of the OGC During operator
    (start < t < end), matching the reference's filter evaluation.
    """

    op: str
    prop: Property
    start: int
    end: Optional[int] = None


@dataclasses.dataclass(frozen=True)
class And:
    children: Tuple["Filter", ...]


@dataclasses.dataclass(frozen=True)
class Or:
    children: Tuple["Filter", ...]


@dataclasses.dataclass(frozen=True)
class Not:
    child: "Filter"


@dataclasses.dataclass(frozen=True)
class Include:
    pass


@dataclasses.dataclass(frozen=True)
class Exclude:
    pass


Filter = Union[
    Comparison,
    Between,
    Like,
    In,
    IsNull,
    SpatialPredicate,
    DistancePredicate,
    TemporalPredicate,
    And,
    Or,
    Not,
    Include,
    Exclude,
]


def walk(f: Filter):
    """Yield every node in the tree, pre-order."""
    yield f
    if isinstance(f, (And, Or)):
        for c in f.children:
            yield from walk(c)
    elif isinstance(f, Not):
        yield from walk(f.child)


def to_cql(f: Filter) -> str:
    """Render a filter back to ECQL text (for explain output)."""
    from geomesa_tpu_torch.core.wkt import to_wkt

    def expr(e: Expr) -> str:
        if isinstance(e, Property):
            return e.name
        v = e.value
        if e.kind == "datetime":
            import numpy as np

            return str(np.datetime64(int(v), "ms")) + "Z"
        if isinstance(v, str):
            return "'" + v.replace("'", "''") + "'"
        return repr(v) if not isinstance(v, bool) else str(v).upper()

    if isinstance(f, Include):
        return "INCLUDE"
    if isinstance(f, Exclude):
        return "EXCLUDE"
    if isinstance(f, Comparison):
        return f"{expr(f.left)} {f.op} {expr(f.right)}"
    if isinstance(f, Between):
        neg = "NOT " if f.negate else ""
        return f"{f.prop.name} {neg}BETWEEN {expr(f.lo)} AND {expr(f.hi)}"
    if isinstance(f, Like):
        op = "ILIKE" if f.case_insensitive else "LIKE"
        neg = "NOT " if f.negate else ""
        pat = f.pattern.replace("'", "''")
        return f"{f.prop.name} {neg}{op} '{pat}'"
    if isinstance(f, In):
        neg = "NOT " if f.negate else ""
        vals = ", ".join(
            "'" + str(v).replace("'", "''") + "'" if isinstance(v, str) else repr(v)
            for v in f.values
        )
        return f"{f.prop.name} {neg}IN ({vals})"
    if isinstance(f, IsNull):
        return f"{f.prop.name} IS {'NOT ' if f.negate else ''}NULL"
    if isinstance(f, SpatialPredicate):
        if f.op == "BBOX":
            x0, y0, x1, y1 = f.geometry.bbox
            return f"BBOX({f.prop.name}, {x0:g}, {y0:g}, {x1:g}, {y1:g})"
        return f"{f.op}({f.prop.name}, {to_wkt(f.geometry)})"
    if isinstance(f, DistancePredicate):
        return f"{f.op}({f.prop.name}, {to_wkt(f.geometry)}, {f.distance_m:g}, meters)"
    if isinstance(f, TemporalPredicate):
        import numpy as np

        t0 = str(np.datetime64(f.start, "ms")) + "Z"
        if f.op == "DURING":
            t1 = str(np.datetime64(f.end, "ms")) + "Z"
            return f"{f.prop.name} DURING {t0}/{t1}"
        return f"{f.prop.name} {f.op} {t0}"
    if isinstance(f, And):
        return "(" + " AND ".join(to_cql(c) for c in f.children) + ")"
    if isinstance(f, Or):
        return "(" + " OR ".join(to_cql(c) for c in f.children) + ")"
    if isinstance(f, Not):
        return f"NOT ({to_cql(f.child)})"
    raise TypeError(f"unknown filter node {f!r}")
