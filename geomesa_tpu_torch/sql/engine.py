"""SQL over feature stores with spatial-predicate pushdown.

Parity: geomesa-spark-sql's GeoMesaRelation + Catalyst rules (SURVEY.md C16)
[upstream, unverified] — SQL spatial predicates are *translated into the
store's CQL filter* so they ride the index/pruning machinery instead of
post-filtering, which is exactly the reference's pushdown contract. Spark
itself is not rebuilt (non-goal per §7); the distributed execution fabric is
the mesh/pjit layer, and this module supplies the SQL surface:

    ctx = SqlContext(datastore)
    ctx.sql("SELECT actor, score FROM gdelt "
            "WHERE st_intersects(geom, st_geomFromWKT('POLYGON(...)')) "
            "AND score > 0 ORDER BY score DESC LIMIT 10")

Supported: SELECT [DISTINCT] cols|*|aggregates (COUNT(*)/COUNT(col)/
SUM/MIN/MAX/AVG, with AS aliases), WHERE with AND/OR/NOT over
st_intersects/st_within/st_contains/st_dwithin/st_bbox + comparisons/
BETWEEN/IN/LIKE (datetime-typed comparisons are translated to temporal
predicates), GROUP BY, HAVING, ORDER BY, LIMIT, and JOIN CHAINS on
attribute equality — INNER / LEFT [OUTER] / RIGHT [OUTER], any number of
tables left-deep (aliases, qualified columns, per-side WHERE pushdown
riding each table's index, vectorized host-side hash join; outer-join
NULLs: NaN doubles, code -1 strings, NULL_I64 ints — the relation-join
surface of SURVEY.md:381-383).

Non-pushable scalar predicates (e.g. `st_area(geom) > 2` in WHERE) follow
the reference's LocalQueryRunner contract (SURVEY.md:219): push what the
index can answer, evaluate the rest as a local post-filter over the fetched
rows — restricted to top-level AND conjuncts (under OR/NOT the index part
would be unsound, so those still raise).

GROUP BY aggregation runs on DEVICE: group ids are factorized host-side,
then each aggregate is one masked segment reduction (engine.stats
grouped_*) — the TPU formulation of the reference's Spark-side aggregation
(SURVEY.md:381-383).

The port's copy of the reference package's `sql/engine.py`. It runs on
the device of the catalog it queries (`DataStore.device`): a spatial join
(`JOIN ... ON st_contains/st_within/st_intersects`) runs the polygon-layer
assignment of `engine/pip_sparse.py` (`pip_layer_join`, the B7 kernel on
the card, its plain PyTorch version on the CPU), and the GROUP BY
reductions are `engine/stats.py`'s grouped_* over tensors, with the
reference's power-of-two padding of rows and groups.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Callable, List, Optional, Tuple

import numpy as np

from geomesa_tpu_torch.core.wkt import Geometry, box, parse_wkt
from geomesa_tpu_torch.cql import ast
from geomesa_tpu_torch.cql.parser import parse_cql  # for datetime literal reuse
from geomesa_tpu_torch.plan.query import Query

_TOKEN_RE = re.compile(
    r"""
    (?P<ws>\s+)
  | (?P<number>-?\d+\.\d*(?:[eE][+-]?\d+)?|-?\.\d+|-?\d+(?:[eE][+-]?\d+)?)
  | (?P<string>'(?:[^']|'')*')
  | (?P<op><>|<=|>=|!=|=|<|>)
  | (?P<punct>[(),*])
  | (?P<word>[A-Za-z_][A-Za-z0-9_.]*)
""",
    re.VERBOSE,
)

_ISO = re.compile(
    r"^\d{4}-\d{2}-\d{2}([T ]\d{2}:\d{2}:\d{2}(\.\d+)?)?(Z|[+-]\d{2}:?\d{2})?$"
)


class SqlError(ValueError):
    pass


class _Tokens:
    def __init__(self, text: str):
        self.toks: List[Tuple[str, str]] = []
        pos = 0
        while pos < len(text):
            m = _TOKEN_RE.match(text, pos)
            if not m:
                raise SqlError(f"bad SQL near {text[pos:pos+20]!r}")
            pos = m.end()
            kind = m.lastgroup
            if kind != "ws":
                self.toks.append((kind, m.group()))
        self.i = 0

    def peek(self, ahead: int = 0) -> Optional[Tuple[str, str]]:
        j = self.i + ahead
        return self.toks[j] if j < len(self.toks) else None

    def next(self) -> Tuple[str, str]:
        if self.i >= len(self.toks):
            raise SqlError("unexpected end of SQL")
        t = self.toks[self.i]
        self.i += 1
        return t

    def accept_word(self, *words: str) -> Optional[str]:
        t = self.peek()
        if t and t[0] == "word" and t[1].upper() in words:
            self.i += 1
            return t[1].upper()
        return None

    def expect_word(self, word: str) -> None:
        if not self.accept_word(word):
            raise SqlError(f"expected {word} at {self.peek()}")

    def expect_punct(self, p: str) -> None:
        t = self.next()
        if t != ("punct", p) and not (t[0] == "punct" and t[1] == p):
            raise SqlError(f"expected {p!r}, got {t}")


_SPATIAL_FNS = {
    # fn -> CQL op when the column is the FIRST arg; the geometry-literal
    # arg supplies the filter geometry. Containment flips with arg order.
    "ST_INTERSECTS": ("INTERSECTS", "INTERSECTS"),
    "ST_WITHIN": ("WITHIN", "CONTAINS"),
    "ST_CONTAINS": ("CONTAINS", "WITHIN"),
    "ST_OVERLAPS": ("OVERLAPS", "OVERLAPS"),
    "ST_CROSSES": ("CROSSES", "CROSSES"),
    "ST_TOUCHES": ("TOUCHES", "TOUCHES"),
    "ST_DISJOINT": ("DISJOINT", "DISJOINT"),
    "ST_EQUALS": ("EQUALS", "EQUALS"),
}

_AGG_FNS = ("COUNT", "SUM", "MIN", "MAX", "AVG")


@dataclasses.dataclass
class _SelectItem:
    kind: str  # "col" | "count" | "count_col" | "sum" | "min" | "max" | "avg"
    col: Optional[str]  # None for COUNT(*)
    alias: str
    explicit_alias: bool = False  # True iff the user wrote AS


@dataclasses.dataclass
class _Where:
    """A parsed WHERE: the index-pushable CQL part + host-evaluated
    residual conjuncts (LocalQueryRunner split, SURVEY.md:219)."""

    cql: ast.Filter
    host: List[Callable]  # each: FeatureBatch -> bool [N]
    host_desc: List[str]


_KEYWORDS = {
    "JOIN", "INNER", "LEFT", "RIGHT", "OUTER", "WHERE", "GROUP", "HAVING",
    "ORDER", "LIMIT", "ON", "AS", "AND", "OR", "NOT", "BY",
}


class _JoinSide:
    def __init__(self, table: str, alias: Optional[str], sft):
        self.table = table
        self.qual = alias or table
        self.sft = sft
        self.filters: List[ast.Filter] = []


def _resolve(sides: List[_JoinSide], name: str):
    """Resolve a (possibly qualified) column reference to (side, col)."""
    if "." in name:
        qual, col = name.split(".", 1)
        for s in sides:
            if s.qual == qual:
                if col not in s.sft:
                    raise SqlError(f"unknown column {name!r}")
                return s, col
        raise SqlError(f"unknown table qualifier {qual!r} in {name!r}")
    owners = [s for s in sides if name in s.sft]
    if len(owners) == 1:
        return owners[0], name
    if not owners:
        raise SqlError(f"unknown column {name!r}")
    raise SqlError(
        f"ambiguous column {name!r}: qualify as "
        + " or ".join(f"{s.qual}.{name}" for s in owners)
    )


class _SqlJoinMixin:
    """Inner equi-join between two feature types (upstream: relation join
    optimizations, SURVEY.md:381-383 [L]). Each side's WHERE conjuncts
    push into that side's store query (riding its index) and the join
    itself is a vectorized sort/searchsorted hash-join host-side."""

    def _maybe_alias(self, toks: _Tokens) -> Optional[str]:
        t = toks.peek()
        if (
            t
            and t[0] == "word"
            and t[1].upper() not in _KEYWORDS
            and "." not in t[1]
        ):
            toks.next()
            return t[1]
        return None

    def _join(self, toks: _Tokens, items, t1: str, a1: Optional[str],
              distinct: bool = False):
        """JOIN chain parser + executor.

        The parse builds a small LOGICAL PLAN — `sides` (table scans with
        per-side pushdown filters) and `steps` (left-deep equi-join steps
        with a kind each: inner / left / right) — executed by
        `_run_join_steps` over per-side row-index arrays where -1 marks
        an outer join's null-extended row. Aggregation, HAVING, DISTINCT,
        ORDER BY and LIMIT then operate on the joined intermediate.

        WHERE placement semantics: conjuncts push into each side's SCAN
        (index-riding, the reference's pushdown contract) — equivalent to
        ON-clause placement. For OUTER joins this deliberately differs
        from standard post-join WHERE, where a predicate on the nullable
        side silently collapses the join to inner; here the filtered side
        simply scans fewer rows and unmatched rows still null-extend."""
        from geomesa_tpu_torch.plan.planner import QueryResult

        if items is None:
            raise SqlError("JOIN needs an explicit select list (no *)")
        sides = [_JoinSide(t1, a1, self.ds.get_schema(t1))]
        steps = []  # (kind, (si_prior, col), (si_new, col))
        while True:
            kind = "inner"
            if toks.accept_word("LEFT"):
                toks.accept_word("OUTER")
                kind = "left"
                toks.expect_word("JOIN")
            elif toks.accept_word("RIGHT"):
                toks.accept_word("OUTER")
                kind = "right"
                toks.expect_word("JOIN")
            elif toks.accept_word("INNER"):
                toks.expect_word("JOIN")
            elif not toks.accept_word("JOIN"):
                break
            tn = toks.next()[1]
            an = self._maybe_alias(toks)
            new_side = _JoinSide(tn, an, self.ds.get_schema(tn))
            if any(s.qual == new_side.qual for s in sides):
                raise SqlError(
                    f"duplicate table qualifier {new_side.qual!r} — "
                    "self-joins need distinct aliases"
                )
            sides.append(new_side)
            ni = len(sides) - 1
            toks.expect_word("ON")
            t = toks.peek()
            if (
                t is not None and t[0] == "word"
                and t[1].lower() in _SPATIAL_JOIN_FNS
                and toks.peek(1) == ("punct", "(")
            ):
                # spatial join: ON st_contains(polys.geom, points.geom) /
                # st_within(points.geom, polys.geom) / st_intersects(...)
                # — executed by the polygon-layer assignment kernel
                # (engine.pip_sparse.pip_layer_join), relation-join parity
                fn = toks.next()[1].lower()
                toks.expect_punct("(")
                s_a, c_a = _resolve(sides, toks.next()[1])
                toks.expect_punct(",")
                s_b, c_b = _resolve(sides, toks.next()[1])
                toks.expect_punct(")")
                ia, ib = sides.index(s_a), sides.index(s_b)
                if ia == ib:
                    raise SqlError("JOIN ON must reference two tables")
                if ni not in (ia, ib):
                    raise SqlError(
                        "JOIN ON must reference the table being joined")
                poly_si = _spatial_poly_side(fn, sides, (ia, c_a), (ib, c_b))
                # 4-tuple marks a spatial step (kind, prior, new, poly_si)
                if ib == ni:
                    steps.append((kind, (ia, c_a), (ib, c_b), poly_si))
                else:
                    steps.append((kind, (ib, c_b), (ia, c_a), poly_si))
                continue
            s_a, c_a = _resolve(sides, toks.next()[1])
            if toks.next() != ("op", "="):
                raise SqlError(
                    "JOIN ON supports equality or "
                    "st_contains/st_within/st_intersects")
            s_b, c_b = _resolve(sides, toks.next()[1])
            ia, ib = sides.index(s_a), sides.index(s_b)
            if ia == ib:
                raise SqlError("JOIN ON must reference two tables")
            if ib == ni:
                steps.append((kind, (ia, c_a), (ib, c_b)))
            elif ia == ni:
                # ON b.x = a.y with the NEW side first: normalize operand
                # order only — LEFT/RIGHT name TABLES, not operands
                steps.append((kind, (ib, c_b), (ia, c_a)))
            else:
                raise SqlError(
                    "JOIN ON must reference the table being joined"
                )

        if toks.accept_word("WHERE"):
            self._join_where(toks, sides)
        group_by: Optional[List[str]] = None
        if toks.accept_word("GROUP"):
            toks.expect_word("BY")
            group_by = [toks.next()[1]]
            while toks.peek() == ("punct", ","):
                toks.next()
                group_by.append(toks.next()[1])
        having = None
        if toks.accept_word("HAVING"):
            having = _parse_having(toks)
        sort_by = None
        if toks.accept_word("ORDER"):
            toks.expect_word("BY")
            sort_by = self._order_list(toks)
        limit = None
        if toks.accept_word("LIMIT"):
            limit = int(toks.next()[1])
        if toks.peek() is not None:
            raise SqlError(f"trailing tokens at {toks.peek()}")

        has_aggs = any(it.kind != "col" for it in items)
        if group_by is not None and not has_aggs:
            raise SqlError("GROUP BY requires aggregate select items")
        if having is not None and not has_aggs:
            raise SqlError("HAVING requires an aggregated select list")

        # one output column per REFERENCED source column (select refs +
        # group keys); aggregates rename their OUTPUT via aliases, the
        # joined intermediate always uses the source-column out names
        out_names: dict = {}  # (si, col) -> out name
        out_items = []  # (si, col, out_name) for the joined batch
        used = set()

        def ref(name: str) -> Tuple[int, str]:
            side, col = _resolve(sides, name)
            si = sides.index(side)
            if (si, col) not in out_names:
                out = col if col not in used and all(
                    col not in s.sft or s is side for s in sides
                ) else f"{side.qual}_{col}"
                used.add(col)
                out_names[(si, col)] = out
                out_items.append((si, col, out))
            return si, col

        group_out: Optional[List[str]] = None
        if group_by is not None:
            group_out = [out_names[ref(g)] for g in group_by]
        item_refs = [
            ref(it.col) if it.col is not None else None for it in items
        ]
        if has_aggs:
            # the joined intermediate must carry >= 1 column so its row
            # count survives (COUNT(*) alone references nothing); the
            # first join key is fetched anyway
            si0, col0 = steps[0][1]
            ref(f"{sides[si0].qual}.{col0}")
        if has_aggs:
            for it, r in zip(items, item_refs):
                if it.kind == "col" and (
                    group_out is None
                    or out_names[r] not in group_out
                ):
                    raise SqlError(
                        f"column {it.col!r} must appear in GROUP BY"
                    )
        else:
            # plain select: aliases rename outputs; duplicates rejected
            used_out = set()
            for it, r in zip(items, item_refs):
                name = it.alias if it.alias != it.col else out_names[r]
                if name in used_out:
                    raise SqlError(
                        f"duplicate output column {name!r} in JOIN select "
                        "list — use distinct AS aliases"
                    )
                used_out.add(name)
            out_items = [
                (r[0], r[1],
                 it.alias if it.alias != it.col else out_names[r])
                for it, r in zip(items, item_refs)
            ]

        # fetch each side with ITS pushable filter, projected to its join
        # keys + that side's selected columns (no host residuals in JOIN
        # WHERE, so the needed set is statically known)
        key_cols: dict = {}  # si -> set of join-key column names
        for step in steps:
            _, (ia, ca), (ib, cb) = step[:3]
            key_cols.setdefault(ia, set()).add(ca)
            key_cols.setdefault(ib, set()).add(cb)
        batches = []
        for si, s in enumerate(sides):
            f: ast.Filter = ast.Include()
            for c in s.filters:
                f = c if isinstance(f, ast.Include) else ast.And((f, c))
            needed = sorted(
                key_cols.get(si, set())
                | {c for j, c, _ in out_items if j == si}
            )
            from geomesa_tpu_torch.utils.config import SystemProperties

            cap = int(SystemProperties.SQL_JOIN_MAX_ROWS.get())
            src_ = self.ds.get_feature_source(s.table)
            # size guard (round-4): joins materialize their sides host-
            # side — a silent 67M-row pull would exhaust host memory.
            # The free manifest total gates whether the (device-cheap)
            # filtered count is even worth running.
            # getattr chain: KV-backed sources have no .storage — the
            # engine stays duck-typed over the FeatureSource surface
            if cap and getattr(
                getattr(src_, "storage", None), "count", 0
            ) > cap:
                est = src_.get_count(Query(s.table, f))
                if est > cap:
                    raise SqlError(
                        f"join side {s.table!r} matches {est} rows "
                        f"(> geomesa.sql.join.max.rows={cap}); push "
                        "filters into WHERE or raise the cap"
                    )
            r = src_.get_features(Query(s.table, f, attributes=needed))
            b = r.features
            if b is None:
                # empty side: materialize a zero-row batch so the join
                # result keeps its schema (no None dereference downstream)
                from geomesa_tpu_torch.core.columnar import FeatureBatch
                from geomesa_tpu_torch.core.sft import SimpleFeatureType

                sub = SimpleFeatureType(
                    s.sft.name,
                    [s.sft.attribute(n_) for n_ in needed],
                    s.sft.user_data,
                )
                b = FeatureBatch.from_pydict(sub, {n_: [] for n_ in needed})
            batches.append(b)

        rowidx = _run_join_steps(batches, steps, self.device)
        result = _join_result(sides, batches, out_items, rowidx)

        names: dict = {}  # any spelling -> final output column name
        if has_aggs:
            # aggregate the joined intermediate with the single-table
            # machinery (device segment reductions, NULL semantics)
            t_items = []
            for it, r in zip(items, item_refs):
                src = out_names[r] if r is not None else None
                alias = it.alias
                if not it.explicit_alias:  # derive from the joined name
                    alias = src if it.kind == "col" else (
                        "count" if it.kind == "count"
                        else f"{it.kind.replace('_col', '')}_{src}"
                    )
                alias = alias.replace(".", "_")
                if any(t.alias == alias for t in t_items):
                    raise SqlError(
                        f"duplicate output column {alias!r} in JOIN select "
                        "list — use distinct AS aliases"
                    )
                t_items.append(_SelectItem(it.kind, src, alias))
                if it.col is not None:
                    names[it.col] = alias
                names[alias] = alias
            result = self._aggregate(
                result.sft, result, t_items, group_out
            )
            if having:
                # translate qualified aggregate args (HAVING SUM(a.price))
                # to the joined intermediate's column names before
                # matching. NAME refs may only be output aliases or group
                # keys — `names` also maps aggregate ARGUMENT spellings
                # (e.g. 'e.score' -> 'sum_score'), which must NOT make a
                # raw ungrouped column reference silently mean its SUM
                h_names = {}
                for it, t in zip(items, t_items):
                    h_names[t.alias] = t.alias
                    if t.kind == "col":
                        h_names[it.col] = t.alias
                        h_names[t.col] = t.alias
                t_having = []
                for h_ref, h_op, h_val in having:
                    if h_ref[0] == "NAME":
                        h_ref = ("NAME", h_names.get(h_ref[1], h_ref[1]))
                    elif h_ref[1] != "*":
                        h_ref = (h_ref[0], out_names[ref(h_ref[1])])
                    t_having.append((h_ref, h_op, h_val))
                result = _apply_having(
                    result, t_having, t_items, [t.alias for t in t_items]
                )
        else:
            for it, (si, col, out) in zip(items, out_items):
                names[out] = out
                names[it.col] = out  # the original (possibly qualified) ref
                names[f"{sides[si].qual}.{col}"] = out
            # a bare column name resolves when exactly one selected output
            # carries it (it may have been renamed qual_col to disambiguate)
            bare: dict = {}
            for si, col, out in out_items:
                bare.setdefault(col, set()).add(out)
            for col, outs in bare.items():
                if col not in names and len(outs) == 1:
                    names[col] = next(iter(outs))
        if sort_by:
            try:
                sort_by = [(names[c], asc) for c, asc in sort_by]
            except KeyError as e:
                raise SqlError(
                    f"ORDER BY column {e.args[0]!r} does not name exactly "
                    "one selected output (columns present on both sides "
                    "are renamed <alias>_<col> for disambiguation); valid "
                    f"spellings: {sorted(set(names))}"
                )
        if distinct:
            result = _distinct_batch(result)
        result = _sort_limit_batch(result, sort_by, limit)
        return QueryResult("features", features=result, count=len(result))

    def _join_where(self, toks: _Tokens, sides: List[_JoinSide]) -> None:
        """Top-level AND conjuncts only; each conjunct must reference ONE
        side (qualified or uniquely-owned columns), gets its qualifiers
        stripped, and re-parses against that side's schema so the full
        single-table predicate grammar applies per side."""
        while True:
            depth = 0
            pending_between = 0  # BETWEEN's own AND must not split
            start = toks.i
            while True:
                t = toks.peek()
                if t is None:
                    break
                if t == ("punct", "("):
                    depth += 1
                elif t == ("punct", ")"):
                    depth -= 1
                elif (
                    depth == 0 and t[0] == "word" and t[1].upper() == "BETWEEN"
                ):
                    # a parenthesized BETWEEN keeps its AND at depth > 0,
                    # where the splitter never breaks anyway
                    pending_between += 1
                elif depth == 0 and t[0] == "word" and t[1].upper() in (
                    "AND", "ORDER", "GROUP", "HAVING", "LIMIT",
                ):
                    if t[1].upper() == "AND" and pending_between > 0:
                        pending_between -= 1
                    else:
                        break
                toks.i += 1
            conjunct = toks.toks[start:toks.i]
            if not conjunct:
                raise SqlError("expected predicate in JOIN WHERE")
            # find the side + strip qualifiers
            side = None
            rewritten = []
            for kind, text in conjunct:
                if kind == "word" and "." in text and not text.replace(".", "").isdigit():
                    qual, col = text.split(".", 1)
                    owner = next((s for s in sides if s.qual == qual), None)
                    if owner is not None:
                        if side is not None and owner is not side:
                            raise SqlError(
                                "JOIN WHERE conjuncts must reference one "
                                f"table each (mixed: {text!r})"
                            )
                        side = owner
                        rewritten.append((kind, col))
                        continue
                rewritten.append((kind, text))
            if side is None:
                # bare columns: unique ownership decides
                for kind, text in rewritten:
                    if kind == "word" and text.upper() not in _KEYWORDS:
                        owners = [s for s in sides if text in s.sft]
                        if len(owners) == 1:
                            side = owners[0]
                            break
            if side is None:
                raise SqlError(
                    "cannot attribute JOIN WHERE conjunct to a table: "
                    + " ".join(t for _, t in conjunct)
                )
            sub = _Tokens("")
            sub.toks = rewritten
            sub.i = 0
            parsed = self._not_expr(sub, side.sft)
            if sub.peek() is not None:
                raise SqlError(
                    f"could not parse JOIN WHERE conjunct at {sub.peek()}"
                )
            if parsed.host:
                raise SqlError(
                    "non-pushable predicates are not supported in JOIN WHERE"
                )
            side.filters.append(parsed.cql)
            if not toks.accept_word("AND"):
                return


def _key_array(batch, col: str) -> np.ndarray:
    from geomesa_tpu_torch.core.columnar import DictColumn, GeometryColumn

    c = batch.columns[col]
    if isinstance(c, GeometryColumn):
        raise SqlError("cannot join on a geometry column")
    if isinstance(c, DictColumn):
        return np.array(
            ["\x00missing" if v is None else v for v in c.decode()]
        )
    return np.asarray(c)


def _equi_join_indices(ba, ca, bb, cb):
    """Vectorized inner equi-join of two batches on named key columns."""
    if ba is None or bb is None or not len(ba) or not len(bb):
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    return _equi_join_indices_keys(_key_array(ba, ca), _key_array(bb, cb))


def _equi_join_indices_keys(ka, kb):
    """Vectorized inner equi-join on key ARRAYS: sort side B once, then
    searchsorted ranges per side-A key; NaN/null keys never match."""
    if not len(ka) or not len(kb):
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    if ka.dtype.kind == "f":
        valid_a = ~np.isnan(ka)
    else:
        valid_a = ka != "\x00missing" if ka.dtype.kind in "UO" else np.ones(len(ka), bool)
    order_b = np.argsort(kb, kind="stable")
    skb = kb[order_b]
    if kb.dtype.kind == "f":
        keep_b = ~np.isnan(skb)
        order_b, skb = order_b[keep_b], skb[keep_b]
    elif kb.dtype.kind in "UO":
        keep_b = skb != "\x00missing"
        order_b, skb = order_b[keep_b], skb[keep_b]
    lo = np.searchsorted(skb, ka, "left")
    hi = np.searchsorted(skb, ka, "right")
    counts = np.where(valid_a, hi - lo, 0)
    total = int(counts.sum())
    if total == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    left = np.repeat(np.arange(len(ka)), counts)
    base = np.repeat(lo, counts)
    cum = np.concatenate([[0], np.cumsum(counts)])[:-1]
    within = np.arange(total) - np.repeat(cum, counts)
    right = order_b[base + within]
    return left, right


# int64 columns (Date/Long) carry outer-join NULLs as this sentinel —
# float columns use NaN and dictionary columns code -1 (the conventions
# the aggregate nonnull_mask already understands)
NULL_I64 = np.iinfo(np.int64).min


_SPATIAL_JOIN_FNS = ("st_contains", "st_within", "st_intersects")
_POLY_KINDS = ("Polygon", "MultiPolygon")


def _spatial_poly_side(fn: str, sides, a, b) -> int:
    """Which side index is the POLYGON side of a spatial join predicate
    (validating the polygon/point geometry kinds)."""

    def kind_of(si, col):
        attr = sides[si].sft.attribute(col)
        if not attr.is_geometry:
            raise SqlError(f"{col!r} is not a geometry column")
        return attr.type

    ta, tb = kind_of(*a), kind_of(*b)
    if fn == "st_contains":     # contains(container, contained)
        poly, pt = a, b
    elif fn == "st_within":     # within(contained, container)
        poly, pt = b, a
    else:                       # st_intersects: kind decides
        if ta in _POLY_KINDS and tb == "Point":
            poly, pt = a, b
        elif tb in _POLY_KINDS and ta == "Point":
            poly, pt = b, a
        else:
            raise SqlError(
                "st_intersects join needs one polygon-kind side and one "
                f"point side (got {ta}, {tb})")
    if kind_of(*poly) not in _POLY_KINDS or kind_of(*pt) != "Point":
        raise SqlError(
            f"{fn} join needs a polygon-kind and a point geometry "
            f"(got {kind_of(*poly)}, {kind_of(*pt)})")
    return poly[0]


def _spatial_pairs(poly_batch, poly_col, pt_batch, pt_col, device):
    """(polygon_rows, point_rows) containment pairs via the polygon-layer
    assignment kernel on `device` (f64 band refinement; overlap
    multiplicity exact)."""
    from geomesa_tpu_torch.engine import pip_sparse

    if len(poly_batch) == 0 or len(pt_batch) == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    et = poly_batch.columns[poly_col].edge_table()
    pc = pt_batch.columns[pt_col]
    args = (
        np.asarray(pc.x, np.float64), np.asarray(pc.y, np.float64),
        np.asarray(et.x1, np.float64), np.asarray(et.y1, np.float64),
        np.asarray(et.x2, np.float64), np.asarray(et.y2, np.float64),
        np.asarray(et.efeat, np.int64),
    )
    # prep is (point-batch x layer)-intrinsic: content-addressed cache
    # (in-process + geomesa.spatial.prep.cache.dir) makes repeated joins
    # and fresh-process first queries skip the host pair build
    prep = pip_sparse.prepare_layer_cached(*args)
    pt_rows, poly_rows = pip_sparse.pip_layer_join(*args, device=device,
                                                   prep=prep)
    return poly_rows.astype(np.int64), pt_rows.astype(np.int64)


def _run_join_steps(batches, steps, device=None):
    """Execute the left-deep join plan -> per-side row-index arrays
    (length = result rows; -1 marks a null-extended outer row); spatial
    steps run on `device`."""
    n_sides = len(batches)
    rowidx = [np.zeros(0, np.int64) for _ in range(n_sides)]
    n0 = len(batches[0]) if batches[0] is not None else 0
    rowidx[0] = np.arange(n0, dtype=np.int64)
    joined = {0}
    for step in steps:
        kind, (ia, ca), (ib, cb) = step[:3]
        if ia not in joined:  # pragma: no cover - parser guarantees order
            raise SqlError("join step references an unjoined table")
        sel = rowidx[ia]
        if len(step) == 4:
            # spatial step: RAW-row containment pairs from the polygon-
            # layer kernel, then the same composite-row machinery with
            # the prior side's ROW INDEX as the join key
            poly_si = step[3]
            if poly_si == ia:
                prow, trow = _spatial_pairs(batches[ia], ca,
                                            batches[ib], cb, device)
                pair_a, pair_b = prow, trow
            else:
                prow, trow = _spatial_pairs(batches[ib], cb,
                                            batches[ia], ca, device)
                pair_a, pair_b = trow, prow
            ka = np.where(sel < 0, NULL_I64, sel)
            li, pi = _equi_join_indices_keys(ka, pair_a)
            ri = pair_b[pi]
        else:
            # key values for the CURRENT result rows (null rows never
            # match)
            ka_full = _key_array(batches[ia], ca)
            if len(ka_full) == 0:  # empty side: every row is null-keyed
                ka_full = np.full(1, np.nan)
            ka = ka_full[np.clip(sel, 0, len(ka_full) - 1)]
            null_row = sel < 0
            if ka.dtype.kind == "f":
                ka = np.where(null_row, np.nan, ka)
            elif ka.dtype.kind in "UO":
                ka = np.where(null_row, "\x00missing", ka)
            else:
                ka = np.where(null_row, NULL_I64, ka)
                # integer sentinel could collide with real data only at
                # INT64_MIN — not a representable Date/Long in practice
            li, ri = _equi_join_indices_keys(ka, _key_array(batches[ib], cb))
        out = []
        for si in range(n_sides):
            if si == ib:
                out.append(ri)
            elif si in joined:
                out.append(rowidx[si][li])
            else:
                out.append(np.zeros(0, np.int64))
        if kind in ("left", "right"):
            if kind == "left":
                matched = np.zeros(len(ka), bool)
                matched[li] = True
                keep = np.nonzero(~matched)[0]
                for si in range(n_sides):
                    if si == ib:
                        out[si] = np.concatenate(
                            [out[si], np.full(len(keep), -1, np.int64)])
                    elif si in joined:
                        out[si] = np.concatenate(
                            [out[si], rowidx[si][keep]])
            else:  # right: keep unmatched NEW-side rows, null the rest
                nb = len(batches[ib]) if batches[ib] is not None else 0
                matched = np.zeros(nb, bool)
                matched[ri] = True
                keep = np.nonzero(~matched)[0]
                for si in range(n_sides):
                    if si == ib:
                        out[si] = np.concatenate([out[si], keep])
                    elif si in joined:
                        out[si] = np.concatenate(
                            [out[si], np.full(len(keep), -1, np.int64)])
        rowidx = out
        joined.add(ib)
    return rowidx


def _join_result(sides, batches, out_items, rowidx):
    import dataclasses as _dc

    from geomesa_tpu_torch.core.columnar import (
        DictColumn, FeatureBatch, GeometryColumn)
    from geomesa_tpu_torch.core.sft import SimpleFeatureType

    attrs = []
    cols = {}
    seen_geom = False
    for si, col, name in out_items:
        a = sides[si].sft.attribute(col)
        default_geom = a.is_geometry and not seen_geom
        seen_geom = seen_geom or a.is_geometry
        take = rowidx[si]
        nulls = take < 0
        has_nulls = bool(nulls.any())
        src = batches[si].columns[col]
        # an EMPTY side can still be null-extended by an outer join: no
        # row 0 exists to alias, so clip against max(len-1, 0) and rely
        # on the null fill below (every take is -1 then)
        safe = np.clip(take, 0, max(len(batches[si]) - 1, 0))
        if len(batches[si]) == 0:
            # all rows null-extended; synthesize a null column directly
            if isinstance(src, DictColumn):
                cols[name] = DictColumn(
                    np.full(len(take), -1, np.int32), list(src.vocab))
            elif isinstance(src, GeometryColumn):
                cols[name] = GeometryColumn.from_points(
                    np.full(len(take), np.nan), np.full(len(take), np.nan))
            else:
                v = np.asarray(src)
                if v.dtype.kind == "f":
                    cols[name] = np.full(len(take), np.nan)
                else:
                    cols[name] = np.full(len(take), NULL_I64, np.int64)
            attrs.append(
                _dc.replace(a, name=name, default_geom=default_geom))
            continue
        if isinstance(src, DictColumn):
            c = src.take(safe)
            if has_nulls:
                codes = np.array(c.codes)
                codes[nulls] = -1
                c = DictColumn(codes, c.vocab)
            cols[name] = c
        elif isinstance(src, GeometryColumn):
            cols[name] = src.take(safe)  # outer-null geometry: row 0 copy
        else:
            v = np.asarray(src)[safe]
            if has_nulls:
                if v.dtype.kind == "f":
                    v = v.copy()
                    v[nulls] = np.nan
                elif v.dtype.kind in "iu":
                    v = v.astype(np.int64, copy=True)
                    v[nulls] = NULL_I64
            cols[name] = v
        attrs.append(
            _dc.replace(a, name=name, default_geom=default_geom)
        )
    sub = SimpleFeatureType("join", attrs)
    return FeatureBatch(sub, cols)


class SqlContext(_SqlJoinMixin):
    """Execute SQL SELECTs against a DataStore-shaped catalog, on the
    catalog's device (the card for a catalog that names none)."""

    def __init__(self, datastore):
        from geomesa_tpu_torch.engine.device import resolve_device

        self.ds = datastore
        self.device = resolve_device(getattr(datastore, "device", None))

    # -- public ------------------------------------------------------------

    def sql(self, text: str):
        """Run a SELECT; returns QueryResult (features/count)."""
        toks = _Tokens(text.strip().rstrip(";"))
        toks.expect_word("SELECT")
        distinct = bool(toks.accept_word("DISTINCT"))
        items = self._select_list(toks)
        toks.expect_word("FROM")
        table = toks.next()[1]
        alias1 = self._maybe_alias(toks)
        nxt = toks.peek()
        if nxt and nxt[0] == "word" and nxt[1].upper() in (
            "JOIN", "INNER", "LEFT", "RIGHT"
        ):
            return self._join(toks, items, table, alias1, distinct=distinct)
        # single-table with an alias: bind it by stripping `alias.` /
        # `table.` qualifiers from every remaining reference (and from the
        # already-parsed select list) so qualified refs resolve
        quals = {f"{q}." for q in (alias1, table) if q}
        if quals:
            def _strip(name: str) -> str:
                for pre in quals:
                    if name.startswith(pre):
                        return name[len(pre):]
                return name

            toks.toks = toks.toks[: toks.i] + [
                (k, _strip(v) if k == "word" else v)
                for k, v in toks.toks[toks.i:]
            ]
            if items is not None:
                for it in items:
                    if it.col is not None:
                        stripped = _strip(it.col)
                        if it.alias == it.col:
                            it.alias = stripped
                        it.col = stripped
        sft = self.ds.get_schema(table)

        where = _Where(ast.Include(), [], [])
        if toks.accept_word("WHERE"):
            where = self._expr(toks, sft)
        group_by: Optional[List[str]] = None
        if toks.accept_word("GROUP"):
            toks.expect_word("BY")
            group_by = [toks.next()[1]]
            while toks.peek() == ("punct", ","):
                toks.next()
                group_by.append(toks.next()[1])
            for c in group_by:
                if c not in sft:
                    raise SqlError(f"unknown GROUP BY column {c!r}")
        having = None
        if toks.accept_word("HAVING"):
            having = _parse_having(toks)
        sort_by = None
        if toks.accept_word("ORDER"):
            toks.expect_word("BY")
            sort_by = self._order_list(toks)
        limit = None
        if toks.accept_word("LIMIT"):
            limit = int(toks.next()[1])
        if toks.peek() is not None:
            raise SqlError(f"trailing tokens at {toks.peek()}")

        src = self.ds.get_feature_source(table)
        has_aggs = items is not None and any(
            it.kind != "col" for it in items
        )
        if group_by is not None and not has_aggs:
            raise SqlError("GROUP BY requires aggregate select items")
        if having is not None and not has_aggs:
            raise SqlError("HAVING requires an aggregated select list")
        if has_aggs:
            for it in items:
                if it.kind == "col" and (
                    group_by is None or it.col not in group_by
                ):
                    raise SqlError(
                        f"column {it.col!r} must appear in GROUP BY"
                    )

        from geomesa_tpu_torch.plan.planner import QueryResult

        # fast path: bare COUNT(*) with fully-pushable WHERE rides the
        # store's count machinery (estimate shortcuts included). LIMIT
        # applies to the (single-row) result, never to the counted rows,
        # so it must NOT become Query.max_features
        if (
            has_aggs
            and group_by is None
            and having is None
            and len(items) == 1
            and items[0].kind == "count"
            and not where.host
        ):
            if limit == 0:
                # LIMIT 0 yields zero rows — WITHOUT scanning anything
                from geomesa_tpu_torch.core.columnar import FeatureBatch
                from geomesa_tpu_torch.core.sft import SimpleFeatureType

                empty = FeatureBatch.from_pydict(
                    SimpleFeatureType.from_spec(
                        "result", f"{items[0].alias}:Long"
                    ),
                    {items[0].alias: np.zeros(0, np.int64)},
                )
                return QueryResult("features", features=empty, count=0)
            q = Query(table, where.cql)
            return QueryResult("count", count=src.get_count(q))

        if has_aggs:
            needed = None
            if not where.host:
                # fetch only the columns the aggregation reads (host
                # predicates would need arbitrary columns, so only the
                # fully-pushed case projects)
                names = list(group_by or [])
                names += [it.col for it in items if it.col is not None]
                needed = sorted(set(names)) or None
            q = Query(table, where.cql, attributes=needed)
            r = src.get_features(q)
            batch = r.features
            if batch is not None and where.host:
                batch = self._apply_host(batch, where)
            result = self._aggregate(sft, batch, items, group_by)
            if having:
                result = _apply_having(
                    result, having, items, [it.alias for it in items]
                )
            if distinct:
                result = _distinct_batch(result)
            result = _sort_limit_batch(result, sort_by, limit)
            return QueryResult(
                "features", features=result, count=len(result)
            )

        cols = [it.col for it in items] if items is not None else None
        if not where.host and not distinct:
            q = Query(
                table, where.cql, attributes=cols,
                sort_by=sort_by, max_features=limit,
            )
            return src.get_features(q)
        if not where.host:  # DISTINCT: dedup before LIMIT, sort pushed
            q = Query(table, where.cql, attributes=cols, sort_by=sort_by)
            r = src.get_features(q)
            batch = _distinct_batch(r.features)
            if batch is not None and limit is not None and len(batch) > limit:
                batch = batch.select(np.arange(limit))
            n_out = 0 if batch is None else len(batch)
            return QueryResult("features", features=batch, count=n_out)
        # local post-filter path: fetch unlimited (the limit applies to
        # post-filter survivors), all attributes (the host predicates may
        # read columns the projection would drop), project afterwards
        q = Query(table, where.cql, sort_by=sort_by)
        r = src.get_features(q)
        batch = r.features
        if batch is None or not len(batch):
            return r
        batch = self._apply_host(batch, where)
        if cols:
            batch = _project(batch, cols)
        if distinct:
            batch = _distinct_batch(batch)
        if limit is not None and len(batch) > limit:
            batch = batch.select(np.arange(limit))
        return QueryResult("features", features=batch, count=len(batch))

    def _apply_host(self, batch, where: _Where):
        m = np.ones(len(batch), bool)
        for hp in where.host:
            m &= np.asarray(hp(batch), bool)
        return batch.select(np.nonzero(m)[0])

    # -- parsing -----------------------------------------------------------

    def _select_list(self, toks: _Tokens) -> Optional[List[_SelectItem]]:
        t = toks.peek()
        if t and t[0] == "punct" and t[1] == "*":
            toks.next()
            return None
        items: List[_SelectItem] = []
        while True:
            items.append(self._select_item(toks))
            if toks.peek() == ("punct", ","):
                toks.next()
                continue
            return items

    def _select_item(self, toks: _Tokens) -> _SelectItem:
        t = toks.next()
        if t[0] != "word":
            raise SqlError(f"expected select item, got {t}")
        up = t[1].upper()
        if up in _AGG_FNS and toks.peek() == ("punct", "("):
            toks.next()
            if toks.peek() == ("punct", "*"):
                toks.next()
                toks.expect_punct(")")
                if up != "COUNT":
                    raise SqlError(f"{up}(*) is not valid SQL")
                item = _SelectItem("count", None, "count")
            else:
                col = toks.next()[1]
                toks.expect_punct(")")
                kind = "count_col" if up == "COUNT" else up.lower()
                item = _SelectItem(kind, col, f"{up.lower()}_{col}")
        else:
            item = _SelectItem("col", t[1], t[1])
        if toks.accept_word("AS"):
            item.alias = toks.next()[1]
            item.explicit_alias = True
        return item

    def _order_list(self, toks: _Tokens):
        out = []
        while True:
            col = toks.next()[1]
            asc = True
            if toks.accept_word("ASC"):
                asc = True
            elif toks.accept_word("DESC"):
                asc = False
            out.append((col, asc))
            if toks.peek() == ("punct", ","):
                toks.next()
                continue
            return out

    def _expr(self, toks: _Tokens, sft) -> _Where:
        left = self._and_expr(toks, sft)
        while toks.accept_word("OR"):
            right = self._and_expr(toks, sft)
            if left.host or right.host:
                raise SqlError(
                    "OR over a non-pushable predicate "
                    f"({(left.host_desc + right.host_desc)[0]}) cannot ride "
                    "the index; restructure as top-level AND conjuncts"
                )
            left = _Where(ast.Or((left.cql, right.cql)), [], [])
        return left

    def _and_expr(self, toks: _Tokens, sft) -> _Where:
        left = self._not_expr(toks, sft)
        while toks.accept_word("AND"):
            right = self._not_expr(toks, sft)
            left = _Where(
                ast.And((left.cql, right.cql)),
                left.host + right.host,
                left.host_desc + right.host_desc,
            )
        return left

    def _not_expr(self, toks: _Tokens, sft) -> _Where:
        if toks.accept_word("NOT"):
            inner = self._not_expr(toks, sft)
            if inner.host:
                raise SqlError(
                    "NOT over a non-pushable predicate "
                    f"({inner.host_desc[0]}) cannot ride the index; "
                    "restructure as top-level AND conjuncts"
                )
            return _Where(ast.Not(inner.cql), [], [])
        if toks.peek() == ("punct", "("):
            save = toks.i
            toks.next()
            try:
                inner = self._expr(toks, sft)
                toks.expect_punct(")")
                return inner
            except SqlError:
                toks.i = save  # not a parenthesized boolean; re-parse
        return self._predicate(toks, sft)

    def _predicate(self, toks: _Tokens, sft) -> _Where:
        t = toks.peek()
        if t is None:
            raise SqlError("expected predicate")
        if t[0] == "word" and t[1].upper() in _SPATIAL_FNS:
            return _Where(self._spatial(toks, sft), [], [])
        if t[0] == "word" and t[1].upper() == "ST_DWITHIN":
            return _Where(self._dwithin(toks, sft), [], [])
        if t[0] == "word" and t[1].upper().startswith("ST_"):
            # scalar st_* expression: evaluate as a LOCAL post-filter
            # (push-what-you-can contract; SURVEY.md:219 LocalQueryRunner)
            return self._host_predicate(toks, sft)
        # column predicate
        col = toks.next()[1]
        if col not in sft:
            raise SqlError(f"unknown column {col!r}")
        is_temporal = sft.attribute(col).is_temporal
        if toks.accept_word("BETWEEN"):
            lo = self._literal(toks, is_temporal)
            toks.expect_word("AND")
            hi = self._literal(toks, is_temporal)
            if is_temporal:
                return _Where(ast.And((
                    ast.Comparison(">=", ast.Property(col), lo),
                    ast.Comparison("<=", ast.Property(col), hi),
                )), [], [])
            return _Where(ast.Between(ast.Property(col), lo, hi), [], [])
        if toks.accept_word("IN"):
            toks.expect_punct("(")
            vals = [self._literal(toks, is_temporal).value]
            while toks.peek() == ("punct", ","):
                toks.next()
                vals.append(self._literal(toks, is_temporal).value)
            toks.expect_punct(")")
            return _Where(ast.In(ast.Property(col), tuple(vals)), [], [])
        if toks.accept_word("LIKE"):
            s = toks.next()
            if s[0] != "string":
                raise SqlError("LIKE needs a string pattern")
            return _Where(
                ast.Like(ast.Property(col), s[1][1:-1].replace("''", "'")),
                [], [],
            )
        if toks.accept_word("IS"):
            negate = bool(toks.accept_word("NOT"))
            toks.expect_word("NULL")
            return _Where(ast.IsNull(ast.Property(col), negate=negate), [], [])
        op_t = toks.next()
        if op_t[0] != "op":
            raise SqlError(f"expected operator after {col}, got {op_t}")
        op = "<>" if op_t[1] == "!=" else op_t[1]
        lit = self._literal(toks, is_temporal)
        return _Where(ast.Comparison(op, ast.Property(col), lit), [], [])

    def _literal(self, toks: _Tokens, temporal: bool) -> ast.Literal:
        t = toks.next()
        if t[0] == "number":
            v = float(t[1])
            return ast.Literal(int(v) if v.is_integer() else v)
        if t[0] == "string":
            s = t[1][1:-1].replace("''", "'")
            if temporal and _ISO.match(s):
                f = parse_cql(f"x TEQUALS {s}")
                return ast.Literal(f.start, kind="datetime")
            return ast.Literal(s)
        if t[0] == "word" and t[1].upper() in ("TRUE", "FALSE"):
            return ast.Literal(t[1].upper() == "TRUE")
        if t[0] == "word" and t[1].upper() == "TIMESTAMP":
            s = toks.next()
            if s[0] != "string":
                raise SqlError("TIMESTAMP needs a quoted ISO string")
            f = parse_cql(f"x TEQUALS {s[1][1:-1]}")
            return ast.Literal(f.start, kind="datetime")
        raise SqlError(f"expected literal, got {t}")

    # -- spatial translation ----------------------------------------------

    def _geom_arg(self, toks: _Tokens, sft):
        """One argument of a spatial fn: a geometry column name or a
        geometry literal expression. Returns ('col', name) | ('geom', g)."""
        t = toks.next()
        up = t[1].upper() if t[0] == "word" else ""
        if up == "ST_GEOMFROMWKT" or up == "ST_GEOMFROMTEXT":
            toks.expect_punct("(")
            s = toks.next()
            if s[0] != "string":
                raise SqlError("st_geomFromWKT needs a quoted WKT string")
            toks.expect_punct(")")
            return "geom", parse_wkt(s[1][1:-1].replace("''", "'"))
        if up == "ST_POINT":
            toks.expect_punct("(")
            x = float(toks.next()[1])
            toks.expect_punct(",")
            y = float(toks.next()[1])
            toks.expect_punct(")")
            return "geom", Geometry("Point", [np.array([[x, y]], np.float64)])
        if up == "ST_MAKEBBOX":
            toks.expect_punct("(")
            vals = [float(toks.next()[1])]
            for _ in range(3):
                toks.expect_punct(",")
                vals.append(float(toks.next()[1]))
            toks.expect_punct(")")
            return "geom", box(*vals)
        if t[0] == "word" and t[1] in sft:
            return "col", t[1]
        raise SqlError(f"expected geometry column or literal, got {t}")

    def _spatial(self, toks: _Tokens, sft) -> ast.Filter:
        fn = toks.next()[1].upper()
        col_first_op, col_second_op = _SPATIAL_FNS[fn]
        toks.expect_punct("(")
        a = self._geom_arg(toks, sft)
        toks.expect_punct(",")
        b = self._geom_arg(toks, sft)
        toks.expect_punct(")")
        if a[0] == "col" and b[0] == "geom":
            return ast.SpatialPredicate(col_first_op, ast.Property(a[1]), b[1])
        if a[0] == "geom" and b[0] == "col":
            return ast.SpatialPredicate(col_second_op, ast.Property(b[1]), a[1])
        raise SqlError(
            f"{fn} needs exactly one geometry column and one literal "
            "(column-column joins go through process.JoinProcess)"
        )

    def _dwithin(self, toks: _Tokens, sft) -> ast.Filter:
        toks.next()  # fn name
        toks.expect_punct("(")
        a = self._geom_arg(toks, sft)
        toks.expect_punct(",")
        b = self._geom_arg(toks, sft)
        toks.expect_punct(",")
        dist = float(toks.next()[1])
        toks.expect_punct(")")
        if a[0] == "col" and b[0] == "geom":
            prop, geom = a[1], b[1]
        elif a[0] == "geom" and b[0] == "col":
            prop, geom = b[1], a[1]
        else:
            raise SqlError("st_dwithin needs one column and one literal")
        # distance in meters (GeoMesa's geomesa-spark st_dwithin contract)
        return ast.DistancePredicate("DWITHIN", ast.Property(prop), geom, dist)

    # -- host (non-pushable) scalar predicates ------------------------------

    def _host_predicate(self, toks: _Tokens, sft) -> _Where:
        """`st_fn(args) op literal` evaluated per row on host (the local
        post-filter leg of the LocalQueryRunner split)."""
        start = toks.i
        expr = self._host_expr(toks, sft)
        op_t = toks.next()
        if op_t[0] != "op":
            raise SqlError(
                f"expected comparison after scalar st_* expression, got {op_t}"
            )
        op = "<>" if op_t[1] == "!=" else op_t[1]
        lit_t = toks.next()
        if lit_t[0] == "number":
            lit = float(lit_t[1])
        elif lit_t[0] == "string":
            lit = lit_t[1][1:-1].replace("''", "'")
        else:
            raise SqlError(f"expected literal, got {lit_t}")
        desc = " ".join(t[1] for t in toks.toks[start:toks.i])
        ops = {
            "=": lambda a, b: a == b, "<>": lambda a, b: a != b,
            "<": lambda a, b: a < b, "<=": lambda a, b: a <= b,
            ">": lambda a, b: a > b, ">=": lambda a, b: a >= b,
        }

        def pred(batch):
            vals = np.array([expr(batch, i) for i in range(len(batch))])
            return ops[op](vals, lit)

        return _Where(ast.Include(), [pred], [desc])

    def _host_expr(self, toks: _Tokens, sft):
        """Parse one scalar/geometry expression into a callable
        (batch, row) -> value. Supports st_* function calls (from
        sql.functions), geometry/numeric column refs, and literals."""
        from geomesa_tpu_torch.sql.functions import FUNCTIONS

        by_upper = {k.upper(): v for k, v in FUNCTIONS.items()}
        t = toks.next()
        if t[0] == "number":
            v = float(t[1])
            return lambda batch, i, v=v: v
        if t[0] == "string":
            s = t[1][1:-1].replace("''", "'")
            return lambda batch, i, s=s: s
        if t[0] != "word":
            raise SqlError(f"expected expression, got {t}")
        up = t[1].upper()
        if up in by_upper and toks.peek() == ("punct", "("):
            fn = by_upper[up]
            toks.next()
            args = []
            if toks.peek() != ("punct", ")"):
                args.append(self._host_expr(toks, sft))
                while toks.peek() == ("punct", ","):
                    toks.next()
                    args.append(self._host_expr(toks, sft))
            toks.expect_punct(")")

            def call(batch, i, fn=fn, args=tuple(args)):
                return fn(*(a(batch, i) for a in args))

            return call
        if t[1] in sft:
            name = t[1]
            attr = sft.attribute(name)
            if attr.is_geometry:
                def geom_ref(batch, i, n=name):
                    return batch.columns[n].geometry(i)
                return geom_ref

            def col_ref(batch, i, n=name):
                from geomesa_tpu_torch.core.columnar import DictColumn

                col = batch.columns[n]
                if isinstance(col, DictColumn):
                    c = col.codes[i]
                    return col.vocab[c] if c >= 0 else None
                return col[i]

            return col_ref
        raise SqlError(f"unknown function or column {t[1]!r}")

    # -- aggregation (device segment reductions) ----------------------------

    def _aggregate(self, sft, batch, items, group_by):
        """GROUP BY execution: factorize group keys host-side, run each
        aggregate as one masked device segment reduction, assemble a
        result FeatureBatch whose schema mirrors the select list."""
        import torch

        from geomesa_tpu_torch.core.columnar import DictColumn, FeatureBatch
        from geomesa_tpu_torch.core.sft import SimpleFeatureType
        from geomesa_tpu_torch.engine.device import fetch
        from geomesa_tpu_torch.engine.stats import (
            grouped_count, grouped_max, grouped_min, grouped_sum)

        n = len(batch) if batch is not None else 0
        group_by = group_by or []

        # factorize each key column, then combine into one group id
        key_codes: List[np.ndarray] = []
        key_decode: List = []  # per key: array of group-representative values
        if n:
            for col_name in group_by:
                col = batch.columns[col_name]
                if isinstance(col, DictColumn):
                    uniq, inv = np.unique(col.codes, return_inverse=True)
                    vals = np.array(
                        [col.vocab[c] if c >= 0 else None for c in uniq],
                        dtype=object,
                    )
                else:
                    uniq, inv = np.unique(
                        np.asarray(col), return_inverse=True
                    )
                    vals = uniq
                key_codes.append(inv)
                key_decode.append(vals)
            if key_codes:
                combined = key_codes[0].astype(np.int64)
                sizes = [len(v) for v in key_decode]
                for c, sz in zip(key_codes[1:], sizes[1:]):
                    combined = combined * sz + c
                gkeys, gids = np.unique(combined, return_inverse=True)
                ngroups = len(gkeys)
                # per-key value index for each group
                key_of_group: List[np.ndarray] = []
                rem = gkeys.copy()
                for sz, vals in zip(reversed(sizes), reversed(key_decode)):
                    key_of_group.append(vals[rem % sz])
                    rem //= sz
                key_of_group.reverse()
            else:
                gids = np.zeros(n, np.int64)
                ngroups = 1
                key_of_group = []
        else:
            gids = np.zeros(0, np.int64)
            ngroups = 0 if group_by else 1
            key_of_group = [np.array([], dtype=object) for _ in group_by]

        # pow2-pad rows AND groups so the segment reductions meet a
        # bounded set of shapes across queries (same policy as the
        # planner's scan path); padded rows carry gid 0 with a False mask
        from geomesa_tpu_torch.utils.padding import next_pow2

        dev = self.device
        np_pad = next_pow2(max(n, 1)) - n
        G = next_pow2(max(ngroups, 1))

        def put(a) -> "torch.Tensor":
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

        def host(t) -> np.ndarray:
            return fetch(t)[0][:ngroups]

        jg = put(np.concatenate([gids, np.zeros(np_pad, np.int64)])
                 .astype(np.int32))
        row_valid = put(np.concatenate([np.ones(n, bool),
                                        np.zeros(np_pad, bool)]))

        def numeric(col_name):
            col = batch.columns[col_name]
            if isinstance(col, DictColumn):
                raise SqlError(
                    f"cannot aggregate string column {col_name!r}"
                )
            arr = np.asarray(col)
            return put(np.concatenate([arr, np.zeros(np_pad, arr.dtype)]))

        def nonnull_mask(col_name):
            """SQL aggregates skip NULLs (NaN doubles / -1 dict codes)."""
            col = batch.columns[col_name]
            if isinstance(col, DictColumn):
                m = col.codes >= 0
            else:
                arr = np.asarray(col)
                m = ~np.isnan(arr) if arr.dtype.kind == "f" else np.ones(n, bool)
            return put(np.concatenate([m, np.zeros(np_pad, bool)]))

        out_cols: dict = {}
        spec_parts: List[str] = []
        for it in items:
            if it.kind == "col":
                vals = key_of_group[group_by.index(it.col)]
                a = sft.attribute(it.col)
                spec_parts.append(f"{it.alias}:{a.type}")
                out_cols[it.alias] = (
                    vals.tolist() if vals.dtype == object else vals
                )
                continue
            if n == 0:
                # empty set: COUNT = 0, every other aggregate is NULL (NaN)
                res = (
                    np.zeros(ngroups, np.float64)
                    if it.kind in ("count", "count_col")
                    else np.full(ngroups, np.nan)
                )
            elif it.kind == "count":
                res = host(grouped_count(jg, row_valid, G))
            elif it.kind == "count_col":
                res = host(grouped_count(jg, nonnull_mask(it.col), G))
            elif it.kind in ("sum", "min", "max", "avg"):
                nn = nonnull_mask(it.col)
                v = numeric(it.col)
                c = host(grouped_count(jg, nn, G))
                if it.kind == "sum":
                    res = host(grouped_sum(v, jg, nn, G))
                elif it.kind == "min":
                    res = host(grouped_min(v, jg, nn, G))
                elif it.kind == "max":
                    res = host(grouped_max(v, jg, nn, G))
                else:
                    s = host(grouped_sum(v, jg, nn, G))
                    res = np.where(c > 0, s / np.maximum(c, 1), np.nan)
                # all-NULL group: SUM/MIN/MAX of an empty set is NULL, not
                # 0 / +-inf
                res = np.where(c > 0, res, np.nan)
            else:  # pragma: no cover
                raise SqlError(f"unknown aggregate {it.kind}")
            if it.kind in ("count", "count_col"):
                spec_parts.append(f"{it.alias}:Long")
                res = res.astype(np.int64)
            else:
                spec_parts.append(f"{it.alias}:Double")
                res = res.astype(np.float64)
            out_cols[it.alias] = res

        rsft = SimpleFeatureType.from_spec("result", ",".join(spec_parts))
        return FeatureBatch.from_pydict(rsft, out_cols)


def _project(batch, cols: List[str]):
    """Column projection of a FeatureBatch (schema + columns subset)."""
    from geomesa_tpu_torch.core.sft import SimpleFeatureType

    attrs = [batch.sft.attribute(c) for c in cols]
    sub = SimpleFeatureType(batch.sft.name, list(attrs), batch.sft.user_data)
    from geomesa_tpu_torch.core.columnar import FeatureBatch

    return FeatureBatch(
        sub, {c: batch.columns[c] for c in cols}, batch.fids, batch.valid
    )


def _distinct_batch(batch):
    """SELECT DISTINCT: drop duplicate result rows (first occurrence
    wins, preserving any prior sort). Row keys: dict codes (batch-local,
    consistent within one result), raw numeric values, and for geometry
    columns the WKT serialization (exact for every kind)."""
    from geomesa_tpu_torch.core.columnar import DictColumn, GeometryColumn

    if batch is None or not len(batch):
        return batch
    keys = []
    for name in batch.sft.attribute_names:
        col = batch.columns.get(name)
        if col is None:
            continue
        if isinstance(col, DictColumn):
            keys.append(np.asarray(col.codes))
        elif isinstance(col, GeometryColumn):
            from geomesa_tpu_torch.core.wkt import to_wkt

            keys.append(np.asarray(
                [to_wkt(col.geometry(i)) for i in range(len(col))],
                dtype=object,
            ))
        else:
            keys.append(np.asarray(col))
    if not keys:
        return batch
    seen: dict = {}
    keep = []
    for i in range(len(batch)):
        k = tuple(a[i] if a.dtype != object else a[i] for a in keys)
        # NaN != NaN would make every null row distinct; canonicalize
        k = tuple(
            "\x00nan" if isinstance(v, float) and v != v else v for v in k
        )
        if k not in seen:
            seen[k] = True
            keep.append(i)
    if len(keep) == len(batch):
        return batch
    return batch.select(np.asarray(keep))


def _sort_limit_batch(batch, sort_by, limit):
    """ORDER BY / LIMIT over a small host-side result batch (aggregate
    outputs; the feature path sorts inside the store instead). Stable
    multi-key: apply keys least-significant first; descending keys sort
    by negated dense rank so stability is preserved."""
    from geomesa_tpu_torch.core.columnar import DictColumn

    if sort_by and len(batch):
        order = np.arange(len(batch))
        for col, asc in reversed(sort_by):
            c = batch.columns[col]
            arr = (
                np.array(["" if v is None else str(v) for v in c.decode()])
                if isinstance(c, DictColumn)
                else np.asarray(c)
            )
            sub = arr[order]
            if asc:
                idx = np.argsort(sub, kind="stable")
            else:
                ranks = np.unique(sub, return_inverse=True)[1]
                idx = np.argsort(-ranks, kind="stable")
            order = order[idx]
        batch = batch.select(order)
    if limit is not None and len(batch) > limit:
        batch = batch.select(np.arange(limit))
    return batch


# -- HAVING -----------------------------------------------------------------

_HAVING_KINDS = {
    "COUNT": ("count", "count_col"),
    "SUM": ("sum",),
    "MIN": ("min",),
    "MAX": ("max",),
    "AVG": ("avg",),
}

_CMP_OPS = {
    "=": lambda a, b: a == b, "<>": lambda a, b: a != b,
    "<": lambda a, b: a < b, "<=": lambda a, b: a <= b,
    ">": lambda a, b: a > b, ">=": lambda a, b: a >= b,
}


def _parse_having(toks: _Tokens):
    """HAVING ref op literal [AND ...]; ref = output alias | AGG(col) |
    COUNT(*). Returns [(ref, op, value)] where ref is ("NAME", x) or
    (AGG, col)."""
    out = []
    while True:
        t = toks.next()
        if t[0] != "word":
            raise SqlError(f"expected HAVING reference, got {t}")
        if t[1].upper() in _AGG_FNS and toks.peek() == ("punct", "("):
            toks.next()
            if toks.peek() == ("punct", "*"):
                toks.next()
                arg = "*"
            else:
                arg = toks.next()[1]
            toks.expect_punct(")")
            ref = (t[1].upper(), arg)
        else:
            ref = ("NAME", t[1])
        op_t = toks.next()
        if op_t[0] != "op":
            raise SqlError(f"expected comparison in HAVING, got {op_t}")
        op = "<>" if op_t[1] == "!=" else op_t[1]
        lit = toks.next()
        if lit[0] == "number":
            v = float(lit[1])
        elif lit[0] == "string":
            v = lit[1][1:-1].replace("''", "'")
        else:
            raise SqlError(f"expected literal in HAVING, got {lit}")
        out.append((ref, op, v))
        if not toks.accept_word("AND"):
            return out


def _having_alias(items, final_aliases, ref) -> str:
    """Map a HAVING reference to the aggregate result's column name."""
    if ref[0] == "NAME":
        for it, fa in zip(items, final_aliases):
            if ref[1] in (it.alias, fa):
                return fa
        raise SqlError(f"HAVING references unknown column {ref[1]!r}")
    for it, fa in zip(items, final_aliases):
        if ref[0] == "COUNT" and ref[1] == "*" and it.kind == "count":
            return fa
        if it.kind in _HAVING_KINDS[ref[0]] and it.col == ref[1]:
            return fa
    raise SqlError(
        f"HAVING references {ref[0]}({ref[1]}) which is not in the "
        "select list"
    )


def _apply_having(batch, having, items, final_aliases):
    from geomesa_tpu_torch.core.columnar import DictColumn

    m = np.ones(len(batch), bool)
    for ref, op, v in having:
        name = _having_alias(items, final_aliases, ref)
        col = batch.columns[name]
        if isinstance(col, DictColumn):
            if not isinstance(v, str):
                raise SqlError(
                    f"HAVING compares string column {name!r} against "
                    f"numeric literal {v!r}"
                )
            vals = np.array(
                ["" if x is None else x for x in col.decode()]
            )
        else:
            if isinstance(v, str):
                raise SqlError(
                    f"HAVING compares numeric column {name!r} against "
                    f"string literal {v!r}"
                )
            vals = np.asarray(col)
        m &= _CMP_OPS[op](vals, v)
    return batch.select(np.nonzero(m)[0])
