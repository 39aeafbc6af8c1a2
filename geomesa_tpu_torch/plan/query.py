"""The Query object.

Parity: the GeoTools Query as used by GeoMesa (filter + projection + sort +
max features + hints) [upstream, unverified]. A copy of the reference
package's `plan/query.py`.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple, Union

from geomesa_tpu_torch.cql import ast, parse_cql
from geomesa_tpu_torch.plan.hints import QueryHints


@dataclasses.dataclass
class Query:
    type_name: str
    filter: Union[str, ast.Filter] = "INCLUDE"
    attributes: Optional[Sequence[str]] = None  # projection; None = all
    sort_by: Optional[Sequence[Tuple[str, bool]]] = None  # (attr, ascending)
    max_features: Optional[int] = None
    # output CRS (EPSG code): result geometries are reprojected in the
    # runner's finish step when this differs from the stored srid
    # (LocalQueryRunner reprojection parity, SURVEY.md:219-220); None =
    # native. Filters/indexes always evaluate in the native CRS.
    crs: Optional[int] = None
    hints: QueryHints = dataclasses.field(default_factory=QueryHints)
    # set by run_interceptors on its output so re-entrant paths (count ->
    # execute -> plan) apply the chain exactly once; upstream's
    # QueryInterceptor SPI does not promise idempotence
    intercepted: bool = dataclasses.field(default=False, compare=False)

    @property
    def filter_ast(self) -> ast.Filter:
        if isinstance(self.filter, str):
            return parse_cql(self.filter)
        return self.filter
