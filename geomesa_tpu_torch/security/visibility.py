"""Visibility expression parsing and evaluation.

Grammar (Accumulo visibility expressions, the reference's model):

    expr   := term (('&' | '|') term)*   -- no mixing & and | without parens
    term   := label | '(' expr ')'
    label  := [A-Za-z0-9_.:/-]+ | "quoted"

An empty expression is visible to everyone. Evaluation: a set of granted
authorizations satisfies a label iff the label is granted; '&' = all,
'|' = any. A copy of the reference package's `security/visibility.py`.
"""

from __future__ import annotations

import re
from typing import FrozenSet, List, Optional, Sequence, Set

import numpy as np

_LABEL = re.compile(r'[A-Za-z0-9_.:/-]+|"(?:[^"\\]|\\.)*"')


class _Node:
    def evaluate(self, auths: FrozenSet[str]) -> bool:
        raise NotImplementedError


class _Label(_Node):
    def __init__(self, name: str):
        self.name = name

    def evaluate(self, auths):
        return self.name in auths


class _And(_Node):
    def __init__(self, children):
        self.children = children

    def evaluate(self, auths):
        return all(c.evaluate(auths) for c in self.children)


class _Or(_Node):
    def __init__(self, children):
        self.children = children

    def evaluate(self, auths):
        return any(c.evaluate(auths) for c in self.children)


class _True(_Node):
    def evaluate(self, auths):
        return True


class VisibilityEvaluator:
    """Parse once, evaluate against many auth sets (cached per expression)."""

    def __init__(self):
        self._cache = {}

    def parse(self, expression: str) -> _Node:
        if expression in self._cache:
            return self._cache[expression]
        node = _parse(expression)
        self._cache[expression] = node
        return node

    def can_see(self, expression: Optional[str], auths: Sequence[str]) -> bool:
        if not expression:
            return True
        return self.parse(expression).evaluate(frozenset(auths))


def _parse(expr: str) -> _Node:
    expr = expr.strip()
    if not expr:
        return _True()
    pos = [0]

    def term() -> _Node:
        _ws()
        if pos[0] < len(expr) and expr[pos[0]] == "(":
            pos[0] += 1
            n = parse_expr()
            _ws()
            if pos[0] >= len(expr) or expr[pos[0]] != ")":
                raise ValueError(f"visibility parse error: missing ')' in {expr!r}")
            pos[0] += 1
            return n
        m = _LABEL.match(expr, pos[0])
        if not m:
            raise ValueError(f"visibility parse error at {expr[pos[0]:]!r}")
        pos[0] = m.end()
        name = m.group()
        if name.startswith('"'):
            name = name[1:-1].replace('\\"', '"')
        return _Label(name)

    def _ws():
        while pos[0] < len(expr) and expr[pos[0]].isspace():
            pos[0] += 1

    def parse_expr() -> _Node:
        nodes = [term()]
        op = None
        while True:
            _ws()
            if pos[0] >= len(expr) or expr[pos[0]] == ")":
                break
            c = expr[pos[0]]
            if c not in "&|":
                raise ValueError(f"visibility parse error at {expr[pos[0]:]!r}")
            if op is None:
                op = c
            elif op != c:
                raise ValueError(
                    f"cannot mix & and | without parentheses: {expr!r}"
                )
            pos[0] += 1
            nodes.append(term())
        if len(nodes) == 1:
            return nodes[0]
        return _And(nodes) if op == "&" else _Or(nodes)

    node = parse_expr()
    if pos[0] != len(expr):
        raise ValueError(f"visibility parse error: trailing input in {expr!r}")
    return node


class AuthorizationsProvider:
    """SPI: which authorizations does the current user hold."""

    def get_authorizations(self) -> List[str]:
        raise NotImplementedError


class StaticAuthorizationsProvider(AuthorizationsProvider):
    def __init__(self, auths: Sequence[str]):
        self.auths = list(auths)

    def get_authorizations(self) -> List[str]:
        return self.auths


def allow_mask(
    vis_vocab: Sequence[Optional[str]],
    vis_codes: np.ndarray,
    auths: Sequence[str],
    evaluator: Optional[VisibilityEvaluator] = None,
) -> np.ndarray:
    """Per-feature bool mask from a dictionary-coded visibility column.

    The allow table is computed once per vocabulary (|vocab| evaluations,
    not |features|), then gathered by code — the precomputed per-batch
    bitmask design. Null visibility (-1 code) = public.
    """
    ev = evaluator or VisibilityEvaluator()
    aset = frozenset(auths)
    table = np.array(
        [ev.parse(v).evaluate(aset) if v else True for v in vis_vocab],
        dtype=bool,
    )
    codes = np.asarray(vis_codes)
    in_range = (codes >= 0) & (codes < len(table))
    safe = np.clip(codes, 0, max(len(table) - 1, 0))
    gathered = table[safe] if len(table) else np.zeros(len(codes), bool)
    # fail-closed: out-of-range codes (stale vocab / corruption) are DENIED;
    # only the null code (-1) means "no visibility" = public
    return np.where(in_range, gathered, codes < 0)
