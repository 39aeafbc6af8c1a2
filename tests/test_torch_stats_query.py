"""Stats queries in the port against the reference package: the device
reductions of `engine/stats.py`, `run_stats` through `execute` with a
`stats_string` hint on both routes (cached and scan), and StatsProcess.

Held exactly: every reduction's output, bit for bit (HyperLogLog
registers and Count-Min tables included: the same 32-bit hash family),
over f64, f32, int64 and int32 values with NaN and infinities; every
stat kind's serialized state (`SeqStat.to_json`) for each expression,
filter and route, over one catalog the reference wrote. One tolerance:
DescriptiveStats' f64 sum and sum of squares within 1e-12 relative,
since an f64 sum's rounding depends on the reduction's order, which
XLA and torch choose differently (the grouped sums are sequential
scatter-adds on the CPU in both packages, so their bits agree).
"""

import json

import numpy as np
import pytest
import torch

import geomesa_tpu.engine.device  # noqa: F401  (the reference runs with x64 on)
import jax.numpy as jnp
from geomesa_tpu.core.columnar import FeatureBatch as RFB
from geomesa_tpu.core.sft import SimpleFeatureType as RSFT
from geomesa_tpu.engine import stats as rst
from geomesa_tpu.plan import DataStore as RDataStore, Query as RQuery
from geomesa_tpu.plan.hints import QueryHints as RHints
from geomesa_tpu.process.misc import StatsProcess as RStatsProcess
from geomesa_tpu.stats.sketches import Frequency as RFrequency
from geomesa_tpu_torch.engine import stats as pst
from geomesa_tpu_torch.plan import DataStore as PDataStore, Query as PQuery
from geomesa_tpu_torch.plan.hints import QueryHints as PHints
from geomesa_tpu_torch.process import StatsProcess as PStatsProcess
from geomesa_tpu_torch.stats.sketches import Frequency as PFrequency

SPEC = "name:String,val:Double,cnt:Integer,dtg:Date,*geom:Point"
T0 = 1_600_000_000_000
DAY = 86400_000
N = 6000


def values(kind, n=5000, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "f64":
        v = rng.normal(0, 10, n)
        v[:6] = [np.nan, np.inf, -np.inf, -0.0, 0.0, 1e300]
    elif kind == "f32":
        v = rng.uniform(-5, 15, n).astype(np.float32)
        v[:3] = [np.nan, np.inf, -0.0]
    elif kind == "i64":
        v = rng.integers(-2**40, 2**40, n)
    else:
        v = rng.integers(-50, 50, n).astype(np.int32)
    return v, rng.random(n) < 0.8, rng.integers(0, 13, n)


def both(fn_ref, fn_port, *arrays, **kw):
    r = fn_ref(*(jnp.asarray(a) for a in arrays), **kw)
    p = fn_port(*(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays), **kw)
    return r, p


def assert_bits(r, p):
    r = r if isinstance(r, tuple) else (r,)
    p = p if isinstance(p, tuple) else (p,)
    for a, b in zip(r, p):
        a, b = np.asarray(a), b.numpy()
        assert a.shape == b.shape and a.dtype == b.dtype, (a.dtype, b.dtype)
        np.testing.assert_array_equal(b, a)


@pytest.mark.parametrize("kind", ["f64", "f32", "i64", "i32"])
@pytest.mark.parametrize("op", ["hll", "cms", "minmax", "moments", "histogram",
                                "grouped_count", "grouped_sum", "grouped_min",
                                "grouped_max", "count"])
def test_reductions_bit_identical(op, kind):
    v, m, g = values(kind)
    if op == "hll":
        assert_bits(*both(rst.hll_registers, pst.hll_registers, v, m, p=12))
    elif op == "cms":
        assert_bits(*both(rst.cms_table, pst.cms_table, v, m, width=1000, depth=4))
    elif op == "minmax":
        assert_bits(*both(rst.masked_minmax, pst.masked_minmax, v, m))
    elif op == "moments":
        assert_bits(*both(rst.masked_moments, pst.masked_moments, v, m))
    elif op == "histogram":
        assert_bits(*both(rst.masked_histogram, pst.masked_histogram, v, m,
                          lo=-3.0, hi=11.5, bins=32))
    elif op == "count":
        assert_bits(*both(rst.masked_count, pst.masked_count, m))
    elif op == "grouped_count":
        assert_bits(rst.grouped_count(jnp.asarray(g, jnp.int32), jnp.asarray(m), 16),
                    pst.grouped_count(torch.from_numpy(g), torch.from_numpy(m), 16))
    else:
        r = getattr(rst, op)(jnp.asarray(v), jnp.asarray(g, jnp.int32),
                             jnp.asarray(m), 16)
        p = getattr(pst, op)(torch.from_numpy(v), torch.from_numpy(g),
                             torch.from_numpy(m), 16)
        assert_bits(r, p)


def test_value_counts_and_z3_histogram_bit_identical():
    rng = np.random.default_rng(4)
    codes = rng.integers(-1, 9, 3000).astype(np.int32)
    m = rng.random(3000) < 0.7
    assert_bits(*both(rst.masked_value_counts, pst.masked_value_counts,
                      codes, m, vocab_size=8))
    x = rng.uniform(-180, 180, 3000).astype(np.float32)
    y = rng.uniform(-90, 90, 3000).astype(np.float32)
    x[:40] = np.round(x[:40] / 22.5) * 22.5  # on cell edges
    x[40], y[41] = np.nan, np.inf
    tb = rng.integers(0, 5, 3000).astype(np.int32)
    assert_bits(*both(rst.z3_histogram, pst.z3_histogram, x, y, tb, m,
                      n_time_bins=8, bins_per_dim=16))


def test_count_min_folds_into_the_same_sketch():
    v, m, _ = values("f64")
    r, p = RFrequency("val", numeric_keys=True), PFrequency("val", numeric_keys=True)
    r.observe_table(np.asarray(rst.cms_table(jnp.asarray(v), jnp.asarray(m),
                                             r.width, r.depth)))
    p.observe_table(pst.cms_table(torch.from_numpy(v), torch.from_numpy(m),
                                  p.width, p.depth).numpy())
    assert json.dumps(p.to_json(), sort_keys=True) == json.dumps(r.to_json(),
                                                                 sort_keys=True)


@pytest.fixture(scope="module")
def catalog(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("torch_stats_query"))
    rng = np.random.default_rng(17)
    cols = {"name": rng.choice(["alpha", "beta", "gamma", None], N).tolist(),
            "val": rng.uniform(-1, 11, N),
            "cnt": rng.integers(0, 40, N).astype(np.int32),
            "dtg": rng.integers(T0, T0 + 20 * DAY, N),
            "geom": np.stack([rng.uniform(-30, 30, N), rng.uniform(20, 60, N)], 1)}
    RDataStore(root).create_schema(RSFT.from_spec("obs", SPEC)).write(
        RFB.from_pydict(RSFT.from_spec("obs", SPEC), cols))
    srcs = {}
    for cached in (True, False):
        srcs[("ref", cached)] = RDataStore(
            root, use_device_cache=cached).get_feature_source("obs")
        srcs[("port", cached)] = PDataStore(
            root, use_device_cache=cached, device="cpu").get_feature_source("obs")
    return srcs


DURING = (f"dtg DURING {np.datetime64(T0 + 2 * DAY, 'ms')}Z/"
          f"{np.datetime64(T0 + 15 * DAY, 'ms')}Z")
FILTERS = {
    "include": "INCLUDE",
    "bbox_during": f"BBOX(geom, -20, 25, 10, 50) AND {DURING}",
    "attribute": "cnt > 30 AND name <> 'beta'",
    "empty": "val > 100",
}
EXPRESSIONS = [
    "Count();MinMax(dtg);Histogram(val,32,0,10);DescriptiveStats(val);Cardinality(val)",
    "MinMax(val);MinMax(cnt)",
    "Cardinality(name);Cardinality(cnt);Cardinality(dtg)",
    "Frequency(name);Frequency(cnt);TopK(name);Enumeration(name)",
    "Histogram(cnt,8,0,40);DescriptiveStats(cnt)",
    "Z3Histogram(geom,dtg,week,8);Z3Histogram(geom,dtg,day,4)",
]


def dumped(seq):
    return json.dumps(seq.to_json(), sort_keys=True)


def assert_same_stats(p, r):
    """Serialized states equal; DescriptiveStats' sums within 1e-12."""
    for a, b in zip(r.stats, p.stats):
        ja, jb = a.to_json(), b.to_json()
        if ja.get("kind") == "descriptive":
            for k in ("sum", "sum_sq"):
                assert abs(jb.pop(k) - ja.pop(k)) <= 1e-12 * max(
                    1.0, abs(a.to_json()[k])), k
        assert json.dumps(jb, sort_keys=True) == json.dumps(ja, sort_keys=True)
    assert len(p.stats) == len(r.stats)


@pytest.mark.parametrize("cached", [True, False], ids=["cached", "scan"])
@pytest.mark.parametrize("filt", sorted(FILTERS))
@pytest.mark.parametrize("expr", range(len(EXPRESSIONS)))
def test_stats_query_equal(catalog, expr, filt, cached):
    e, cql = EXPRESSIONS[expr], FILTERS[filt]
    r = catalog[("ref", cached)].get_features(
        RQuery("obs", cql, hints=RHints(stats_string=e)))
    p = catalog[("port", cached)].get_features(
        PQuery("obs", cql, hints=PHints(stats_string=e)))
    assert p.kind == r.kind == "stats"
    assert p.count == r.count
    assert_same_stats(p.stats, r.stats)


def test_stats_explain_and_process(catalog):
    e = EXPRESSIONS[0]
    assert "Aggregation: stats" in catalog[("port", True)].explain(
        PQuery("obs", "INCLUDE", hints=PHints(stats_string=e)))
    cql = FILTERS["bbox_during"]
    r = RStatsProcess().execute(catalog[("ref", True)], e, cql)
    p = PStatsProcess().execute(catalog[("port", True)], e, cql)
    assert_same_stats(p, r)
    assert p.stats[0].result() == r.stats[0].result()
