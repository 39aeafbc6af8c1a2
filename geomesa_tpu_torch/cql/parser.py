"""Recursive-descent ECQL parser.

Parity: the ECQL surface consumed by geomesa-filter via GeoTools' ECQL class
[upstream, unverified], covering the predicate set in SURVEY.md C4. Grammar
(precedence low->high): OR, AND, NOT, predicate.

Literals: numbers, single-quoted strings ('' escapes a quote), TRUE/FALSE,
ISO-8601 datetimes (2020-01-02T03:04:05Z, optional fraction/Z, date-only),
datetime ranges a/b for DURING, inline WKT geometry literals, and unit names
for DWITHIN/BEYOND (meters, kilometers, feet, statute miles, nautical miles).

A copy of the reference package's `cql/parser.py`.
"""

from __future__ import annotations

import re
from typing import List, Optional, Tuple

import numpy as np

from geomesa_tpu_torch.core.wkt import Geometry, box, parse_wkt
from geomesa_tpu_torch.cql import ast

_TOKEN_RE = re.compile(
    r"""
    (?P<ws>\s+)
  | (?P<datetime>\d{4}-\d{2}-\d{2}(?:[T ]\d{2}:\d{2}:\d{2}(?:\.\d+)?)?(?:Z|[+-]\d{2}:?\d{2})?)
  | (?P<number>-?\d+\.\d*(?:[eE][+-]?\d+)?|-?\.\d+|-?\d+(?:[eE][+-]?\d+)?)
  | (?P<string>'(?:[^']|'')*')
  | (?P<op><>|<=|>=|=|<|>)
  | (?P<punct>[(),/])
  | (?P<word>[A-Za-z_][A-Za-z0-9_.:]*)
""",
    re.VERBOSE,
)

_GEOM_KINDS = {
    "POINT",
    "LINESTRING",
    "POLYGON",
    "MULTIPOINT",
    "MULTILINESTRING",
    "MULTIPOLYGON",
    "GEOMETRYCOLLECTION",
}

_SPATIAL_OPS = {
    "INTERSECTS",
    "WITHIN",
    "CONTAINS",
    "OVERLAPS",
    "CROSSES",
    "TOUCHES",
    "DISJOINT",
    "EQUALS",
}

_UNITS_TO_M = {
    "meters": 1.0,
    "meter": 1.0,
    "m": 1.0,
    "kilometers": 1000.0,
    "kilometer": 1000.0,
    "km": 1000.0,
    "feet": 0.3048,
    "foot": 0.3048,
    "statute miles": 1609.344,
    "miles": 1609.344,
    "mile": 1609.344,
    "nautical miles": 1852.0,
}


class Token:
    __slots__ = ("kind", "text")

    def __init__(self, kind: str, text: str):
        self.kind = kind
        self.text = text

    def __repr__(self):
        return f"{self.kind}:{self.text}"


def _tokenize(text: str) -> List[Token]:
    out: List[Token] = []
    pos = 0
    while pos < len(text):
        m = _TOKEN_RE.match(text, pos)
        if not m:
            raise ValueError(f"CQL tokenize error at {text[pos:pos+20]!r}")
        pos = m.end()
        kind = m.lastgroup
        if kind == "ws":
            continue
        out.append(Token(kind, m.group()))
    return out


def _parse_datetime_ms(s: str) -> int:
    s = s.strip()
    # normalize offset/Z to UTC
    m = re.match(r"^(.*?)(Z|[+-]\d{2}:?\d{2})$", s)
    offset_ms = 0
    if m and m.group(2) != "Z" and len(m.group(2)) >= 5:
        body, off = m.group(1), m.group(2).replace(":", "")
        sign = 1 if off[0] == "+" else -1
        offset_ms = sign * (int(off[1:3]) * 3600 + int(off[3:5]) * 60) * 1000
        s = body
    elif m:
        s = m.group(1)
    s = s.replace(" ", "T")
    return int(np.datetime64(s, "ms").astype(np.int64)) - offset_ms


class _Parser:
    def __init__(self, text: str):
        self.text = text
        self.tokens = _tokenize(text)
        self.pos = 0

    # -- token helpers ----------------------------------------------------

    def peek(self, ahead: int = 0) -> Optional[Token]:
        i = self.pos + ahead
        return self.tokens[i] if i < len(self.tokens) else None

    def next(self) -> Token:
        t = self.peek()
        if t is None:
            raise ValueError(f"CQL parse error: unexpected end of {self.text!r}")
        self.pos += 1
        return t

    def accept_word(self, *words: str) -> Optional[str]:
        t = self.peek()
        if t and t.kind == "word" and t.text.upper() in words:
            self.pos += 1
            return t.text.upper()
        return None

    def expect_punct(self, p: str):
        t = self.next()
        if t.text != p:
            raise ValueError(f"CQL parse error: expected {p!r}, got {t.text!r}")

    # -- grammar ----------------------------------------------------------

    def parse(self) -> ast.Filter:
        f = self.or_expr()
        if self.peek() is not None:
            raise ValueError(f"CQL parse error: trailing input at {self.peek()!r}")
        return f

    def or_expr(self) -> ast.Filter:
        parts = [self.and_expr()]
        while self.accept_word("OR"):
            parts.append(self.and_expr())
        return parts[0] if len(parts) == 1 else ast.Or(tuple(parts))

    def and_expr(self) -> ast.Filter:
        parts = [self.not_expr()]
        while self.accept_word("AND"):
            parts.append(self.not_expr())
        return parts[0] if len(parts) == 1 else ast.And(tuple(parts))

    def not_expr(self) -> ast.Filter:
        if self.accept_word("NOT"):
            return ast.Not(self.not_expr())
        return self.predicate()

    def predicate(self) -> ast.Filter:
        t = self.peek()
        if t is None:
            raise ValueError("CQL parse error: empty predicate")
        if t.text == "(":
            self.next()
            f = self.or_expr()
            self.expect_punct(")")
            return f
        if t.kind == "word":
            word = t.text.upper()
            if word == "INCLUDE":
                self.next()
                return ast.Include()
            if word == "EXCLUDE":
                self.next()
                return ast.Exclude()
            if word == "BBOX":
                return self.bbox()
            if word in _SPATIAL_OPS:
                return self.spatial(word)
            if word in ("DWITHIN", "BEYOND"):
                return self.distance(word)
        return self.attribute_predicate()

    def bbox(self) -> ast.Filter:
        self.next()  # BBOX
        self.expect_punct("(")
        prop = ast.Property(self.next().text)
        nums = []
        for _ in range(4):
            self.expect_punct(",")
            nums.append(float(self.next().text))
        # optional CRS string argument
        if self.peek() and self.peek().text == ",":
            self.next()
            self.next()  # ignore CRS; WGS84 is the native frame
        self.expect_punct(")")
        return ast.SpatialPredicate("BBOX", prop, box(nums[0], nums[1], nums[2], nums[3]))

    def spatial(self, op: str) -> ast.Filter:
        self.next()
        self.expect_punct("(")
        prop = ast.Property(self.next().text)
        self.expect_punct(",")
        geom = self.geometry_literal()
        self.expect_punct(")")
        return ast.SpatialPredicate(op, prop, geom)

    def distance(self, op: str) -> ast.Filter:
        self.next()
        self.expect_punct("(")
        prop = ast.Property(self.next().text)
        self.expect_punct(",")
        geom = self.geometry_literal()
        self.expect_punct(",")
        dist = float(self.next().text)
        self.expect_punct(",")
        # unit may be one or two words (statute miles, nautical miles)
        unit_words = [self.next().text.lower()]
        while self.peek() and self.peek().kind == "word" and self.peek().text != ")":
            unit_words.append(self.next().text.lower())
        unit = " ".join(unit_words)
        if unit not in _UNITS_TO_M:
            raise ValueError(f"unknown distance unit {unit!r}")
        self.expect_punct(")")
        return ast.DistancePredicate(op, prop, geom, dist * _UNITS_TO_M[unit])

    def geometry_literal(self) -> Geometry:
        t = self.peek()
        if t is None or t.kind != "word" or t.text.upper() not in _GEOM_KINDS:
            raise ValueError(f"CQL parse error: expected geometry literal at {t!r}")
        # consume tokens through balanced parens, rebuild text, reuse WKT parser
        parts = [self.next().text]
        # optional Z/M tag
        if self.peek() and self.peek().kind == "word" and self.peek().text.upper() in ("Z", "M", "ZM", "EMPTY"):
            parts.append(self.next().text)
            if parts[-1].upper() == "EMPTY":
                return parse_wkt(" ".join(parts))
        depth = 0
        while True:
            t = self.next()
            parts.append(t.text)
            if t.text == "(":
                depth += 1
            elif t.text == ")":
                depth -= 1
                if depth == 0:
                    break
        return parse_wkt(" ".join(parts))

    def attribute_predicate(self) -> ast.Filter:
        t = self.peek()
        if t is not None and t.kind in ("number", "string", "datetime"):
            # literal-first comparison: 17 < age
            lit = self.literal()
            op_t = self.next()
            if op_t.kind != "op":
                raise ValueError(f"CQL parse error: expected operator, got {op_t.text!r}")
            prop_t = self.next()
            if prop_t.kind != "word":
                raise ValueError(f"CQL parse error: expected attribute, got {prop_t.text!r}")
            return ast.Comparison(op_t.text, lit, ast.Property(prop_t.text))
        t = self.next()
        if t.kind != "word":
            raise ValueError(f"CQL parse error: expected attribute at {t!r}")
        prop = ast.Property(t.text)

        if self.accept_word("DURING"):
            start = _parse_datetime_ms(self.next().text)
            self.expect_punct("/")
            end = _parse_datetime_ms(self.next().text)
            return ast.TemporalPredicate("DURING", prop, start, end)
        for tword in ("BEFORE", "AFTER", "TEQUALS"):
            if self.accept_word(tword):
                return ast.TemporalPredicate(
                    tword, prop, _parse_datetime_ms(self.next().text)
                )

        negate = bool(self.accept_word("NOT"))
        if self.accept_word("BETWEEN"):
            lo = self.literal()
            if not self.accept_word("AND"):
                raise ValueError("CQL parse error: BETWEEN requires AND")
            hi = self.literal()
            return ast.Between(prop, lo, hi, negate=negate)
        if self.accept_word("LIKE") or self.accept_word("ILIKE"):
            ci = self.tokens[self.pos - 1].text.upper() == "ILIKE"
            pat = self.literal()
            return ast.Like(prop, str(pat.value), case_insensitive=ci, negate=negate)
        if self.accept_word("IN"):
            self.expect_punct("(")
            vals = [self.literal().value]
            while self.peek() and self.peek().text == ",":
                self.next()
                vals.append(self.literal().value)
            self.expect_punct(")")
            return ast.In(prop, tuple(vals), negate=negate)
        if self.accept_word("IS"):
            neg = bool(self.accept_word("NOT"))
            if not self.accept_word("NULL"):
                raise ValueError("CQL parse error: IS [NOT] NULL expected")
            return ast.IsNull(prop, negate=neg)
        if negate:
            raise ValueError("CQL parse error: NOT must precede BETWEEN/LIKE/IN")

        op_t = self.next()
        if op_t.kind != "op":
            raise ValueError(f"CQL parse error: expected operator, got {op_t.text!r}")
        rhs = self.literal_or_property()
        return ast.Comparison(op_t.text, prop, rhs)

    def literal(self) -> ast.Literal:
        t = self.next()
        if t.kind == "number":
            v = float(t.text)
            return ast.Literal(int(v) if v.is_integer() and "." not in t.text and "e" not in t.text.lower() else v)
        if t.kind == "string":
            return ast.Literal(t.text[1:-1].replace("''", "'"))
        if t.kind == "datetime":
            return ast.Literal(_parse_datetime_ms(t.text), kind="datetime")
        if t.kind == "word" and t.text.upper() in ("TRUE", "FALSE"):
            return ast.Literal(t.text.upper() == "TRUE")
        raise ValueError(f"CQL parse error: expected literal, got {t.text!r}")

    def literal_or_property(self):
        t = self.peek()
        if t and t.kind == "word" and t.text.upper() not in ("TRUE", "FALSE"):
            self.pos += 1
            return ast.Property(t.text)
        return self.literal()


def parse_cql(text: str) -> ast.Filter:
    """Parse an ECQL filter expression into the typed AST."""
    text = text.strip()
    if not text:
        return ast.Include()
    return _Parser(text).parse()
