"""Spatial SQL of the port: the st_* function library (the
geomesa-spark-jts analog, `sql/functions.py`) and `SqlContext`
(`sql/engine.py`), copies of the reference package's `sql/`.

Parity: geomesa-spark/geomesa-spark-jts st_* Catalyst functions [upstream,
unverified] — constructors, accessors, predicates, measures and casts — as
Python functions usable standalone over scalars, Geometry objects, or
columnar arrays (the Spark-free equivalent of registering UDFs).

`register()` returns the full name->callable table for embedding in other
engines (e.g. a dataframe library or an expression evaluator).
"""

from geomesa_tpu_torch.sql.functions import FUNCTIONS, register  # noqa: F401
from geomesa_tpu_torch.sql.functions import *  # noqa: F401,F403
from geomesa_tpu_torch.sql.engine import SqlContext, SqlError  # noqa: F401
