"""The Query object.

Parity: the GeoTools Query as used by GeoMesa (filter + max features +
hints) [upstream, unverified]. A copy of the reference package's
`plan/query.py` without the projection, sort and CRS fields: this slice
answers counts and kNN only, which read none of them.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

from geomesa_tpu_torch.cql import ast, parse_cql
from geomesa_tpu_torch.plan.hints import QueryHints


@dataclasses.dataclass
class Query:
    type_name: str
    filter: Union[str, ast.Filter] = "INCLUDE"
    max_features: Optional[int] = None
    hints: QueryHints = dataclasses.field(default_factory=QueryHints)

    @property
    def filter_ast(self) -> ast.Filter:
        if isinstance(self.filter, str):
            return parse_cql(self.filter)
        return self.filter
