"""The Query object.

Parity: the GeoTools Query as used by GeoMesa (filter + projection + sort
+ max features + hints) [upstream, unverified]. A copy of the reference
package's `plan/query.py` without the output CRS (reprojection comes with
its slice) and the interceptor marker (interceptors come with theirs): a
query cannot carry them here, so it cannot silently ignore them.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple, Union

from geomesa_tpu_torch.cql import ast, parse_cql
from geomesa_tpu_torch.plan.hints import QueryHints


@dataclasses.dataclass
class Query:
    type_name: str
    filter: Union[str, ast.Filter] = "INCLUDE"
    attributes: Optional[Sequence[str]] = None  # projection; None = all
    sort_by: Optional[Sequence[Tuple[str, bool]]] = None  # (attr, ascending)
    max_features: Optional[int] = None
    hints: QueryHints = dataclasses.field(default_factory=QueryHints)

    @property
    def filter_ast(self) -> ast.Filter:
        if isinstance(self.filter, str):
            return parse_cql(self.filter)
        return self.filter
