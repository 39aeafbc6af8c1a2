"""Query planning and execution of the port: Query, hints, the planner
(counts, kNN and density) and the DataStore / FeatureSource entry API."""

from geomesa_tpu_torch.plan.hints import QueryHints
from geomesa_tpu_torch.plan.query import Query
from geomesa_tpu_torch.plan.planner import KnnLaunch, QueryPlan, QueryPlanner, QueryResult
from geomesa_tpu_torch.plan.datastore import DataStore, FeatureSource
from geomesa_tpu_torch.plan.explain import Explainer

__all__ = [
    "Query", "QueryHints", "QueryPlanner", "QueryPlan", "QueryResult", "KnnLaunch",
    "DataStore", "FeatureSource", "Explainer",
]
