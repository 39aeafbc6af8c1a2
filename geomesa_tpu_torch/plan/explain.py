"""Explain logging.

Parity: geomesa-index-api Explainer / explain-logging [upstream, unverified]:
an indenting plan narrator, printed by `explain` CLI and attachable to any
query for plan debugging.

A copy of the reference package's `plan/explain.py`.
"""

from __future__ import annotations

from typing import List


class Explainer:
    def __init__(self):
        self.lines: List[str] = []
        self._depth = 0

    def __call__(self, msg: str) -> "Explainer":
        self.lines.append("  " * self._depth + msg)
        return self

    def push(self, msg: str) -> "Explainer":
        self(msg)
        self._depth += 1
        return self

    def pop(self) -> "Explainer":
        self._depth = max(0, self._depth - 1)
        return self

    def render(self) -> str:
        return "\n".join(self.lines)

    def __str__(self):
        return self.render()
