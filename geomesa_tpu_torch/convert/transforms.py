"""Transform expression DSL.

A copy of the reference package's `convert/transforms.py`, modelled on
o.l.g.convert2 Transformers [upstream, unverified]. Grammar:

  expr     := cast | call | ref | literal
  cast     := expr '::' type          (int, long, double, float, string, boolean)
  ref      := '$' digits | '$' name   (source column by position or name)
  call     := name '(' [expr (',' expr)*] ')'
  literal  := 'single-quoted' | number

Functions (the commonly-used upstream set): concat, trim, strip, lowercase,
uppercase, substring, replace, regexReplace, length, md5, murmurHash3, uuid,
point, geometry (WKT parse), dateParse (Java-style patterns), isoDate,
isoDateTime, secsToDate, millisToDate, toInt/toLong/toDouble/toFloat/
toString/toBoolean, stringToInt..., withDefault, require, lineNo.

Evaluation is row-wise over an EvalContext (ingest is a host-side path; the
device sees only the resulting columnar batch).
"""

from __future__ import annotations

import dataclasses
import hashlib
import re
import uuid as _uuid
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

Value = object


@dataclasses.dataclass
class EvalContext:
    """One source record: positional fields ($0 = whole line upstream;
    kept here as the raw record string) + named fields + line number."""

    positional: Sequence[Value]
    named: Dict[str, Value]
    line_no: int = 0
    raw: str = ""


_TOKEN = re.compile(
    r"""\s*(?:
      (?P<dollar>\$[A-Za-z0-9_.]+)
    | (?P<number>-?\d+\.\d*|-?\d+)
    | (?P<string>'(?:[^']|'')*')
    | (?P<name>[A-Za-z_][A-Za-z0-9_]*)
    | (?P<cast>::)
    | (?P<punct>[(),])
    )""",
    re.VERBOSE,
)


def _tokenize(s: str):
    out, pos = [], 0
    while pos < len(s):
        m = _TOKEN.match(s, pos)
        if not m:
            raise ValueError(f"transform parse error at {s[pos:pos+15]!r}")
        pos = m.end()
        for kind in ("dollar", "number", "string", "name", "cast", "punct"):
            if m.group(kind) is not None:
                out.append((kind, m.group(kind)))
                break
    return out


# longer tokens first (MMM before MM, EEE before any E handling) so prefix
# tokens can't corrupt them; quoted literals go through placeholders so a
# later token rule can never rewrite their contents
_JAVA_TO_STRPTIME = [
    ("'T'", "\x01"), ("'Z'", "\x02"),
    ("yyyy", "%Y"), ("EEE", "%a"), ("MMM", "%b"), ("MM", "%m"),
    ("dd", "%d"), ("HH", "%H"), ("mm", "%M"), ("ss", "%S"),
    ("SSS", "%f"), ("DDD", "%j"), ("Z", "%z"),
    ("\x01", "T"), ("\x02", "Z"),
]


def _java_pattern(p: str) -> str:
    for a, b in _JAVA_TO_STRPTIME:
        p = p.replace(a, b)
    return p


_EN_MONTHS = {
    "Jan": "01", "Feb": "02", "Mar": "03", "Apr": "04", "May": "05",
    "Jun": "06", "Jul": "07", "Aug": "08", "Sep": "09", "Oct": "10",
    "Nov": "11", "Dec": "12",
}
_EN_DAYS = ("Mon", "Tue", "Wed", "Thu", "Fri", "Sat", "Sun")


def _parse_date(pattern: str, v: str) -> int:
    import datetime as dt
    import re as _re

    fmt = _java_pattern(pattern)
    s = str(v).strip()
    # EEE/MMM name tokens are defined as ENGLISH in the Java patterns these
    # configs come from, but strptime's %a/%b follow LC_TIME — normalize to
    # numerics/removal so parsing is locale-independent
    if "%b" in fmt:
        for name, num in _EN_MONTHS.items():
            if name in s:
                s = s.replace(name, num, 1)
                break
        fmt = fmt.replace("%b", "%m")
    if "%a" in fmt:
        s = _re.sub(r"(?:%s)\s*" % "|".join(_EN_DAYS), "", s, count=1)
        fmt = _re.sub(r"%a\s*", "", fmt, count=1)
    d = dt.datetime.strptime(s, fmt)
    if d.tzinfo is None:
        d = d.replace(tzinfo=dt.timezone.utc)
    return int(d.timestamp() * 1000)


def _iso_millis(v: str) -> int:
    s = str(v).strip()
    if s.endswith("Z"):
        s = s[:-1]
    return int(np.datetime64(s, "ms").astype(np.int64))


def _num(v) -> float:
    if isinstance(v, str):
        v = v.strip()
        if v == "":
            raise ValueError("empty numeric field")
    return float(v)


_FUNCTIONS: Dict[str, Callable] = {
    "concat": lambda ctx, *a: "".join(str(x) for x in a),
    "trim": lambda ctx, v: str(v).strip(),
    "strip": lambda ctx, v, chars=None: str(v).strip(chars),
    "lowercase": lambda ctx, v: str(v).lower(),
    "uppercase": lambda ctx, v: str(v).upper(),
    "substring": lambda ctx, v, a, b: str(v)[int(a): int(b)],
    "replace": lambda ctx, v, a, b: str(v).replace(str(a), str(b)),
    "regexReplace": lambda ctx, rx, rep, v: re.sub(str(rx), str(rep), str(v)),
    "length": lambda ctx, v: len(str(v)),
    "md5": lambda ctx, v: hashlib.md5(str(v).encode()).hexdigest(),
    "murmurHash3": lambda ctx, v: int.from_bytes(
        hashlib.blake2b(str(v).encode(), digest_size=4).digest(), "big"
    ),
    "uuid": lambda ctx: str(_uuid.uuid4()),
    "point": lambda ctx, x, y: (float(_num(x)), float(_num(y))),
    "geometry": lambda ctx, v: _parse_geom(v),
    "dateParse": lambda ctx, pattern, v: _parse_date(pattern, v),
    "date": lambda ctx, pattern, v: _parse_date(pattern, v),
    "isoDate": lambda ctx, v: _iso_millis(v),
    "isoDateTime": lambda ctx, v: _iso_millis(v),
    "secsToDate": lambda ctx, v: int(_num(v) * 1000),
    "millisToDate": lambda ctx, v: int(_num(v)),
    "toInt": lambda ctx, v, default=None: _safe(int, _num, v, default),
    "toLong": lambda ctx, v, default=None: _safe(int, _num, v, default),
    "toDouble": lambda ctx, v, default=None: _safe(float, _num, v, default),
    "toFloat": lambda ctx, v, default=None: _safe(float, _num, v, default),
    "toString": lambda ctx, v: str(v),
    "toBoolean": lambda ctx, v: str(v).strip().lower() in ("true", "1", "t", "yes"),
    "stringToInt": lambda ctx, v, default=None: _safe(int, _num, v, default),
    "stringToDouble": lambda ctx, v, default=None: _safe(float, _num, v, default),
    "withDefault": lambda ctx, v, default: default if v in (None, "") else v,
    "require": lambda ctx, v: _require(v),
    "lineNo": lambda ctx: ctx.line_no,
}


def _safe(outer, inner, v, default):
    try:
        return outer(inner(v))
    except (ValueError, TypeError):
        if default is None:
            raise
        return default


def _require(v):
    if v in (None, ""):
        raise ValueError("required field is empty")
    return v


def _parse_geom(v):
    from geomesa_tpu_torch.core.wkt import parse_wkt

    return parse_wkt(str(v))


_CASTS = {
    "int": lambda v: int(_num(v)),
    "long": lambda v: int(_num(v)),
    "integer": lambda v: int(_num(v)),
    "double": lambda v: float(_num(v)),
    "float": lambda v: float(_num(v)),
    "string": str,
    "boolean": lambda v: str(v).strip().lower() in ("true", "1", "t", "yes"),
}


class _Parser:
    def __init__(self, tokens):
        self.tokens = tokens
        self.pos = 0

    def peek(self):
        return self.tokens[self.pos] if self.pos < len(self.tokens) else (None, None)

    def next(self):
        t = self.peek()
        self.pos += 1
        return t

    def expression(self):
        node = self.primary()
        while self.peek()[0] == "cast":
            self.next()
            kind, text = self.next()
            if kind != "name" or text.lower() not in _CASTS:
                raise ValueError(f"unknown cast type {text!r}")
            node = ("cast", text.lower(), node)
        return node

    def primary(self):
        kind, text = self.next()
        if kind == "dollar":
            key = text[1:]
            return ("ref", int(key)) if key.isdigit() else ("refname", key)
        if kind == "number":
            return ("lit", float(text) if "." in text else int(text))
        if kind == "string":
            return ("lit", text[1:-1].replace("''", "'"))
        if kind == "name":
            nkind, ntext = self.peek()
            if ntext == "(":
                self.next()
                args = []
                if self.peek()[1] != ")":
                    args.append(self.expression())
                    while self.peek()[1] == ",":
                        self.next()
                        args.append(self.expression())
                if self.next()[1] != ")":
                    raise ValueError("transform parse error: expected ')'")
                if text not in _FUNCTIONS:
                    raise ValueError(f"unknown transform function {text!r}")
                return ("call", text, args)
            return ("lit", text)  # bareword literal
        raise ValueError(f"transform parse error at {text!r}")


def compile_expression(expr: str) -> Callable[[EvalContext], Value]:
    """Compile a transform expression into ctx -> value."""
    tokens = _tokenize(expr)
    parser = _Parser(tokens)
    tree = parser.expression()
    if parser.pos != len(tokens):
        raise ValueError(f"trailing input in transform {expr!r}")

    def ev(node, ctx: EvalContext):
        tag = node[0]
        if tag == "lit":
            return node[1]
        if tag == "ref":
            i = node[1]
            return ctx.positional[i] if i < len(ctx.positional) else None
        if tag == "refname":
            return ctx.named.get(node[1])
        if tag == "cast":
            return _CASTS[node[1]](ev(node[2], ctx))
        if tag == "call":
            args = [ev(a, ctx) for a in node[2]]
            return _FUNCTIONS[node[1]](ctx, *args)
        raise AssertionError(node)

    return lambda ctx: ev(tree, ctx)
