"""Query interceptors: pre-planning query rewrite/veto hooks.

Parity: geomesa-index-api's `QueryInterceptor` SPI plus its full-table-scan
guards (upstream `o.l.g.index.planning.QueryInterceptor` and the
`geomesa.scan.block.full.table` property) [upstream, unverified]. The
reference loads interceptor classes per feature type and runs them before
strategy selection; a guard interceptor may reject the query outright.

A copy of the reference package's `plan/interceptor.py`. Interceptors are plain callables `Query -> Query`
registered on a planner (or passed per DataStore); raising aborts planning.
The built-in `FullTableScanGuard` mirrors the reference's guard semantics:
a filter that constrains neither space, time, attributes, nor ids is a
full-table scan and is rejected when blocking is enabled (explicitly or via
the `geomesa.scan.block.full.table` system property).
"""

from __future__ import annotations

from typing import Callable, List

from geomesa_tpu_torch.cql import ast

# an interceptor maps a Query to a (possibly rewritten) Query; raising
# QueryGuardException vetoes execution
Interceptor = Callable[["Query"], "Query"]


class QueryGuardException(Exception):
    """A guard interceptor rejected the query (upstream: the planner's
    full-table-scan / max-ranges guard errors)."""


def _is_unconstrained(f: ast.Filter) -> bool:
    """True when the filter cannot narrow the scan at all: INCLUDE, a
    NOT(EXCLUDE)-style tautology, or an OR with an unconstrained arm."""
    if isinstance(f, ast.Include):
        return True
    if isinstance(f, ast.Or):
        return any(_is_unconstrained(c) for c in f.children)
    if isinstance(f, ast.And):
        return all(_is_unconstrained(c) for c in f.children)
    if isinstance(f, ast.Not):
        # NOT of anything cannot be proven constraining without evaluation;
        # treat bare NOT at the top level as unconstrained (matches the
        # reference's conservative guard)
        return True
    return False


class FullTableScanGuard:
    """Reject queries whose filter constrains nothing. Unconstrained
    queries that carry a sampling hint pass: the reference permits guarded
    stores to serve sampled previews.
    """

    def __call__(self, query: "Query") -> "Query":
        if _is_unconstrained(query.filter_ast):
            if query.hints.sampling:
                return query
            raise QueryGuardException(
                f"full-table scan blocked for '{query.type_name}': filter "
                f"{ast.to_cql(query.filter_ast)!r} constrains nothing "
                "(geomesa.scan.block.full.table)"
            )
        return query


def load_interceptors(sft) -> List[Interceptor]:
    """Instantiate interceptors configured on the feature type (upstream:
    the `geomesa.query.interceptors` user-data key lists classes loaded per
    SFT). Value: comma-separated dotted paths to zero-arg callables/classes;
    the literal `full-table-scan-guard` names the built-in guard.

    Dotted paths execute attacker-chosen importable callables if schema
    metadata was written by another party, so they load only when the
    `geomesa.query.interceptors.load` system property opts in ; the built-in guard always loads."""
    import importlib

    from geomesa_tpu_torch.utils.config import SystemProperties

    spec = (sft.user_data or {}).get("geomesa.query.interceptors", "")
    out: List[Interceptor] = []
    skipped: List[str] = []
    for path in (p.strip() for p in spec.split(",") if p.strip()):
        if path == "full-table-scan-guard":
            out.append(FullTableScanGuard())
            continue
        if not SystemProperties.LOAD_INTERCEPTORS.get():
            skipped.append(path)
            continue
        mod, _, attr = path.rpartition(".")
        obj = getattr(importlib.import_module(mod), attr)
        out.append(obj() if isinstance(obj, type) else obj)
    if skipped:
        import logging

        logging.getLogger(__name__).warning(
            "ignoring configured query interceptors %s: set "
            "geomesa.query.interceptors.load=true to allow dotted-path "
            "interceptor loading from schema metadata",
            skipped,
        )
    return out


def run_interceptors(
    query: "Query", interceptors: List[Interceptor], explain=None
) -> "Query":
    """Apply interceptors in registration order; each sees the previous
    one's output (upstream: interceptors chain per feature type).

    The chain runs exactly ONCE per query: the output is marked
    `intercepted=True` and re-entrant paths (count -> execute -> plan) pass
    through unchanged, so interceptors need not be idempotent (upstream's
    QueryInterceptor SPI makes no such promise).

    The property-driven guard runs AFTER the chain, so a configured rewrite
    interceptor gets the chance to constrain an INCLUDE query before the
    guard judges it (upstream guards evaluate the post-interceptor query).
    """
    import dataclasses

    from geomesa_tpu_torch.utils.config import SystemProperties

    if query.intercepted:
        return query
    for ic in interceptors:
        before = query
        query = ic(query)
        if explain is not None and query is not before:
            explain(f"Interceptor {type(ic).__name__} rewrote the query")
    if SystemProperties.SCAN_BLOCK_FULL_TABLE.get():
        query = FullTableScanGuard()(query)
    return dataclasses.replace(query, intercepted=True)
