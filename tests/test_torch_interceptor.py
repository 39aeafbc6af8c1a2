"""Query interceptors on the port (`geomesa_tpu_torch.plan.interceptor`)
against the reference's.

One catalog (written by the reference) serves both packages on the CPU.
The full-table-scan guard judges the same filters the same way, directly
and through `geomesa.scan.block.full.table` (a guarded INCLUDE count is a
typed error on the wire, a sampled one passes). Schema-configured
interceptors load as the reference loads them (dotted paths only under
`geomesa.query.interceptors.load`). A non-idempotent rewrite runs exactly
once per count, execute and kNN, and the answers equal the reference's
and an oracle of the once-rewritten query. A planner with interceptors
refuses the ring, so its served kNN rides the pipelined route and equals
the direct call.
"""

import json

import numpy as np
import pytest

import geomesa_tpu.serve as rserve
import geomesa_tpu.serve.protocol  # noqa: F401
import geomesa_tpu_torch.serve as pserve
import geomesa_tpu_torch.serve.protocol  # noqa: F401
from geomesa_tpu.core.columnar import FeatureBatch as RFB
from geomesa_tpu.core.sft import SimpleFeatureType as RSFT
from geomesa_tpu.plan import interceptor as ric
from geomesa_tpu.plan.datastore import DataStore as RDataStore
from geomesa_tpu.plan.hints import QueryHints as RHints
from geomesa_tpu.plan.query import Query as RQuery
from geomesa_tpu.utils.config import SystemProperties as RProps
from geomesa_tpu_torch.cql import parse_cql
from geomesa_tpu_torch.faults import fallback
from geomesa_tpu_torch.plan import interceptor as pic
from geomesa_tpu_torch.plan.datastore import DataStore as PDataStore
from geomesa_tpu_torch.plan.hints import QueryHints as PHints
from geomesa_tpu_torch.plan.planner import RingIneligible
from geomesa_tpu_torch.plan.query import Query as PQuery
from geomesa_tpu_torch.utils.config import SystemProperties as PProps

SPEC = "name:String,score:Double,dtg:Date,*geom:Point"
T0, DAY = 1_600_000_000_000, 86_400_000
N = 2000
CQL = "BBOX(geom, -60, -30, 60, 50)"
PKG = {"ref": (RQuery, RHints, RProps, ric, rserve),
       "port": (PQuery, PHints, PProps, pic, pserve)}


class AppendTerm:
    """Not idempotent: every call ANDs one more `score > i` term and a
    seven-day window, so running twice changes the answer."""

    def __init__(self):
        self.calls = 0

    def __call__(self, query):
        import dataclasses

        self.calls += 1
        cql = (f"({query.filter if isinstance(query.filter, str) else 'INCLUDE'})"
               f" AND score > {self.calls - 5} AND dtg DURING "
               "2020-09-13T00:00:00Z/2020-09-20T00:00:00Z")
        return dataclasses.replace(query, filter=cql)


@pytest.fixture(scope="module")
def rows():
    rng = np.random.default_rng(4)
    return {"name": rng.choice(["a", "b"], N).tolist(),
            "score": rng.uniform(-10, 10, N),
            "dtg": rng.integers(T0 - 10 * DAY, T0 + 20 * DAY, N),
            "geom": np.stack([rng.uniform(-170, 170, N),
                              rng.uniform(-80, 80, N)], 1)}


@pytest.fixture(scope="module")
def root(tmp_path_factory, rows):
    root = str(tmp_path_factory.mktemp("torch_icpt"))
    sft = RSFT.from_spec("t", SPEC)
    RDataStore(root, use_device_cache=True).create_schema(sft).write(
        RFB.from_pydict(sft, rows))
    return root


def stores(root):
    return {"ref": RDataStore(root, use_device_cache=True),
            "port": PDataStore(root, use_device_cache=True, device="cpu")}


@pytest.fixture()
def block_full_table():
    for props in (RProps, PProps):
        props.set("geomesa.scan.block.full.table", True)
    yield
    for props in (RProps, PProps):
        props.clear("geomesa.scan.block.full.table")


@pytest.mark.parametrize("cql, blocked", [
    ("INCLUDE", True), ("NOT (score > 1)", True), ("score > 1 OR INCLUDE", True),
    (CQL, False), ("score > 1 AND INCLUDE", False), ("INCLUDE AND INCLUDE", True)])
def test_guard_judges_as_reference(cql, blocked):
    for pkg, (q_cls, h_cls, _, ic, _) in PKG.items():
        guard = ic.FullTableScanGuard()
        q = q_cls("t", cql)
        if blocked:
            with pytest.raises(ic.QueryGuardException, match="full-table"):
                guard(q)
            sampled = q_cls("t", cql, hints=h_cls(sampling=4))
            assert guard(sampled) is sampled
        else:
            assert guard(q) is q
        assert pic._is_unconstrained(parse_cql(cql)) == blocked


def test_property_guard_on_counts_and_the_wire(root, block_full_table):
    s = stores(root)
    lines = [{"id": "c", "op": "count", "typeName": "t", "cql": "INCLUDE"},
             {"id": "f", "op": "count", "typeName": "t", "cql": CQL}]
    got = {}
    for pkg, (q_cls, h_cls, _, ic, serve) in PKG.items():
        src = s[pkg].get_feature_source("t")
        with pytest.raises(ic.QueryGuardException):
            src.get_count(q_cls("t", "INCLUDE"))
        n = src.get_count(q_cls("t", "INCLUDE", hints=h_cls(sampling=4)))
        assert n == (N + 3) // 4
        out = []
        serve.protocol.serve_lines(
            s[pkg], (json.dumps(d) for d in lines), out.append,
            serve.ServeConfig(pipeline=False, ring=False))
        got[pkg] = {d["id"]: d for d in map(json.loads, out)}
    assert got["port"] == got["ref"]
    assert got["port"]["c"]["ok"] is False
    assert "full-table scan blocked" in got["port"]["c"]["message"]
    assert got["port"]["f"]["ok"] is True


def test_guard_refuses_a_tolerant_count_over_warm_sketches(root):
    """The admission-time sketch peek runs the property guard too: with
    sketches warm, a tolerant INCLUDE count still answers the typed guard
    error, while a constrained tolerant count is served approximately."""
    src = stores(root)["port"].get_feature_source("t")
    warm = src.planner.count(PQuery(
        "t", "BBOX(geom, -180, -90, 180, 90)", hints=PHints(tolerance=0.5)))
    assert getattr(warm, "bound", None) is not None
    lines = [{"id": "c", "op": "count", "typeName": "t", "cql": "INCLUDE",
              "tolerance": 0.5},
             {"id": "f", "op": "count", "typeName": "t", "cql": CQL,
              "tolerance": 0.5}]
    PProps.set("geomesa.scan.block.full.table", True)
    try:
        with pytest.raises(pic.QueryGuardException):
            src.planner.approx_count_result(
                PQuery("t", "INCLUDE", hints=PHints(tolerance=0.5)))
        out = []
        pserve.protocol.serve_lines(
            stores(root)["port"], (json.dumps(d) for d in lines), out.append,
            pserve.ServeConfig(pipeline=False, ring=False))
    finally:
        PProps.clear("geomesa.scan.block.full.table")
    got = {d["id"]: d for d in map(json.loads, out)}
    assert got["c"]["ok"] is False
    assert "full-table scan blocked" in got["c"]["message"]
    assert got["f"]["ok"] is True and got["f"]["approx"] is True


def test_schema_interceptors_load_as_reference(tmp_path, caplog):
    from geomesa_tpu_torch.core.sft import SimpleFeatureType as PSFT

    sft = {"ref": RSFT.from_spec("t", SPEC), "port": PSFT.from_spec("t", SPEC)}
    for t in sft.values():
        t.user_data["geomesa.query.interceptors"] = (
            "full-table-scan-guard, tests.test_torch_interceptor.AppendTerm")
    for opted in (False, True):
        names = {}
        for pkg, (_, _, props, ic, _) in PKG.items():
            if opted:
                props.set("geomesa.query.interceptors.load", True)
            try:
                names[pkg] = [type(i).__name__
                              for i in ic.load_interceptors(sft[pkg])]
            finally:
                props.clear("geomesa.query.interceptors.load")
        assert names["port"] == names["ref"]
        assert names["port"] == (["FullTableScanGuard", "AppendTerm"] if opted
                                 else ["FullTableScanGuard"])
    ds = PDataStore(str(tmp_path), device="cpu")
    src = ds.create_schema(sft["port"])
    assert [type(i).__name__ for i in src.planner.interceptors] == [
        "FullTableScanGuard"]
    with pytest.raises(pic.QueryGuardException):
        src.get_count("INCLUDE")


def test_rewrite_runs_once_per_query(root, rows):
    s = stores(root)
    qx, qy = np.array([1.0, -20.0, 40.0]), np.array([2.0, 10.0, -5.0])
    got = {}
    for pkg, (q_cls, h_cls, _, _, _) in PKG.items():
        pl = s[pkg].get_feature_source("t").planner
        ic = AppendTerm()
        pl.interceptors.append(ic)
        try:
            n = pl.count(q_cls("t", CQL))
            assert ic.calls == 1
            r = pl.execute(q_cls("t", CQL, sort_by=[("score", True)]))
            assert ic.calls == 2
            d, i, b = pl.knn(q_cls("t", CQL), qx, qy, k=5)
            assert ic.calls == 3
            exp = pl.plan(q_cls("t", CQL), None)
            assert ic.calls == 4 and exp.query.intercepted
        finally:
            pl.interceptors.remove(ic)
        got[pkg] = (n, r.features.columns["score"], d, i)
    assert got["port"][0] == got["ref"][0]
    np.testing.assert_array_equal(got["port"][1], got["ref"][1])
    for a, b in zip(got["port"][3], got["ref"][3]):
        assert set(a.tolist()) == set(b.tolist())
    np.testing.assert_array_equal(got["port"][2], got["ref"][2])
    # the oracle of the once-rewritten query (score > -4 after call 1)
    x, y = rows["geom"][:, 0], rows["geom"][:, 1]
    t, sc = rows["dtg"], rows["score"]
    lo, hi = 1_599_955_200_000, 1_600_560_000_000
    oracle = ((x >= -60) & (x <= 60) & (y >= -30) & (y <= 50) & (sc > -4)
              & (t > lo) & (t < hi))
    assert got["port"][0] == int(oracle.sum())


def test_explain_and_host_fallback_run_the_chain(root):
    s = stores(root)
    src = s["port"].get_feature_source("t")
    ic = AppendTerm()
    src.planner.interceptors.append(ic)
    try:
        assert "Interceptor AppendTerm rewrote the query" in src.explain(CQL)
        q = PQuery("t", CQL)
        ic.calls = 0
        n = fallback.host_count(src, q)
        ic.calls = 0
        assert n == src.get_count(q)
    finally:
        src.planner.interceptors.remove(ic)


def test_ring_refuses_and_served_knn_equals_direct(root):
    s = stores(root)
    qs = np.random.default_rng(1).uniform(-40, 40, (6, 2))
    for pkg, (q_cls, _, _, _, serve) in PKG.items():
        pl = s[pkg].get_feature_source("t").planner
        pl.interceptors.append(AppendTerm())
        if pkg == "port":
            with pytest.raises(RingIneligible) as ei:
                pl.ring_arm(q_cls("t", CQL), q_padded=8, k=5)
            assert ei.value.reason == "interceptors"
        svc = serve.QueryService(s[pkg], serve.ServeConfig(max_wait_ms=1.0))
        try:
            for x, y in qs:
                served = svc.knn("t", CQL, np.array([x]), np.array([y]),
                                 k=5).result(timeout=300)
                pl.interceptors[0].calls = 0  # same rewrite as the served one
                direct = pl.knn(q_cls("t", CQL), np.array([x]), np.array([y]),
                                k=5)
                pl.interceptors[0].calls = 0
                np.testing.assert_array_equal(served[0], direct[0])
                np.testing.assert_array_equal(served[1], direct[1])
            ring = svc.stats()["pipeline"].get("ring", {})
        finally:
            svc.close(drain=True)
            pl.interceptors.clear()
        assert ring.get("windows", 0) == 0
        assert ring.get("fallbacks", {}).get("interceptors", 0) >= 1
