"""Query deadlines: the port's planner raises the reference's typed
`QueryTimeout` at the reference's phases and reads geomesa.query.timeout
where the reference does.

Both packages' planners run over one catalog, on the cached route and on
the scan route. A phase is made slow by wrapping the step that ends it
(`plan` ends "planning"; the storage scan, or the kNN mask, ends "scan")
with a 300 ms sleep, against a 200 ms budget, so the outcome does not
depend on how fast this machine plans. `execute` and `count` read the
property when no timeout is given; `knn` does not, in either package.
Without a deadline (or with one that holds) results are unchanged.
"""

import time

import numpy as np
import pytest

from geomesa_tpu.core.columnar import FeatureBatch as RFB
from geomesa_tpu.core.sft import SimpleFeatureType as RSFT
from geomesa_tpu.faults import current_deadline as r_current_deadline
from geomesa_tpu.plan.datastore import DataStore as RDataStore
from geomesa_tpu.plan.planner import QueryTimeout as RQueryTimeout
from geomesa_tpu.plan.query import Query as RQuery
from geomesa_tpu_torch.faults import current_deadline as p_current_deadline
from geomesa_tpu_torch.plan.datastore import DataStore as PDataStore
from geomesa_tpu_torch.plan.planner import QueryTimeout as PQueryTimeout
from geomesa_tpu_torch.plan.query import Query as PQuery

CQL = "BBOX(geom, -100, -50, 100, 50) AND score > 0"
BUDGET_MS = 200
SLOW_S = 0.3

TIMEOUT = {"ref": RQueryTimeout, "port": PQueryTimeout}
QUERY = {"ref": RQuery, "port": PQuery}
DEADLINE = {"ref": r_current_deadline, "port": p_current_deadline}


@pytest.fixture(scope="module")
def sources(tmp_path_factory):
    """{(pkg, route): FeatureSource} over one catalog; route "cached"
    (device cache on) or "scan"."""
    root = str(tmp_path_factory.mktemp("torch_timeout"))
    rng = np.random.default_rng(5)
    n = 800
    sft = RSFT.from_spec("timed", "score:Double,dtg:Date,*geom:Point")
    RDataStore(root).create_schema(sft).write(RFB.from_pydict(sft, {
        "score": rng.uniform(-10, 10, n),
        "dtg": rng.integers(1_590_000_000_000, 1_590_300_000_000, n),
        "geom": np.stack([rng.uniform(-170, 170, n),
                          rng.uniform(-80, 80, n)], 1)}))
    out = {}
    for cached in (True, False):
        route = "cached" if cached else "scan"
        out["ref", route] = RDataStore(
            root, use_device_cache=cached).get_feature_source("timed")
        out["port", route] = PDataStore(
            root, use_device_cache=cached, device="cpu").get_feature_source("timed")
    return out


def slowed(fn):
    def slow(*a, **kw):
        time.sleep(SLOW_S)
        return fn(*a, **kw)

    return slow


def call(pkg, src, entry, timeout_ms="unset"):
    kw = {} if timeout_ms == "unset" else {"timeout_ms": timeout_ms}
    if entry == "execute":
        return src.planner.execute(QUERY[pkg]("timed", CQL), **kw)
    if entry == "count":
        return src.planner.count(QUERY[pkg]("timed", CQL), **kw)
    return src.planner.knn(CQL, [1.0, 2.0], [3.0, 4.0], k=3, **kw)


def slow_phase(monkeypatch, src, entry, phase):
    if phase == "planning":
        monkeypatch.setattr(src.planner, "plan", slowed(src.planner.plan))
    elif entry == "knn":
        monkeypatch.setattr(src.planner, "_knn_mask_setup",
                            slowed(src.planner._knn_mask_setup))
    else:
        monkeypatch.setattr(src.storage, "scan", slowed(src.storage.scan))


CASES = [("execute", "planning", "cached"), ("execute", "planning", "scan"),
         ("execute", "scan", "scan"), ("count", "planning", "cached"),
         ("count", "scan", "scan"), ("knn", "planning", "cached"),
         ("knn", "scan", "cached"), ("knn", "scan", "scan")]


@pytest.mark.parametrize("entry, phase, route", CASES,
                         ids=["-".join(c) for c in CASES])
def test_phases_match_reference(sources, monkeypatch, entry, phase, route):
    errors = {}
    for pkg in ("ref", "port"):
        src = sources[pkg, route]
        with monkeypatch.context() as m:
            slow_phase(m, src, entry, phase)
            with pytest.raises(TIMEOUT[pkg]) as ei:
                call(pkg, src, entry, timeout_ms=BUDGET_MS)
        e = ei.value
        assert isinstance(e, TimeoutError)
        assert e.phase == phase and e.timeout_ms == BUDGET_MS
        assert e.elapsed_ms > BUDGET_MS
        errors[pkg] = e
    prefix = f"query exceeded timeout={BUDGET_MS}ms during {phase} (elapsed "
    assert all(str(e).startswith(prefix) for e in errors.values())


@pytest.mark.parametrize("entry", ["execute", "count", "knn"])
@pytest.mark.parametrize("pkg", ["ref", "port"])
def test_query_timeout_property(sources, monkeypatch, pkg, entry):
    """geomesa.query.timeout bounds execute and count when no timeout is
    passed; knn reads only its argument (in both packages); an explicit
    0 turns the property off."""
    src = sources[pkg, "cached"]
    monkeypatch.setenv("GEOMESA_TPU_QUERY_TIMEOUT", str(BUDGET_MS))
    monkeypatch.setattr(src.planner, "plan", slowed(src.planner.plan))
    if entry == "knn":
        d, _, _ = call(pkg, src, entry)
        assert np.isfinite(d).all()
    else:
        with pytest.raises(TIMEOUT[pkg]) as ei:
            call(pkg, src, entry)
        assert ei.value.phase == "planning"
    call(pkg, src, entry, timeout_ms=0)
    monkeypatch.setenv("GEOMESA_TPU_QUERY_TIMEOUT", "0")
    call(pkg, src, entry)


@pytest.mark.parametrize("entry", ["execute", "count", "knn"])
@pytest.mark.parametrize("pkg", ["ref", "port"])
def test_calls_run_in_a_deadline_scope(sources, monkeypatch, pkg, entry):
    src = sources[pkg, "cached"]
    seen = []
    plan = src.planner.plan

    def plan_and_look(*a, **kw):
        seen.append(DEADLINE[pkg]())
        return plan(*a, **kw)

    monkeypatch.setattr(src.planner, "plan", plan_and_look)
    t0 = time.monotonic()
    call(pkg, src, entry, timeout_ms=5000)
    call(pkg, src, entry, timeout_ms=None)
    assert t0 < seen[0] <= time.monotonic() + 5.0
    assert seen[1] is None
    assert DEADLINE[pkg]() is None


@pytest.mark.parametrize("route", ["cached", "scan"])
def test_results_unchanged_by_a_deadline_that_holds(sources, route):
    src = sources["port", route]
    ref = sources["ref", route]
    count = src.planner.count(PQuery("timed", CQL), timeout_ms=60_000)
    assert count == src.planner.count(PQuery("timed", CQL))
    assert count == ref.planner.count(RQuery("timed", CQL), timeout_ms=60_000)
    r = src.planner.execute(PQuery("timed", CQL), timeout_ms=60_000)
    assert r.kind == "features" and len(r.features) == count
    d1, i1, _ = src.planner.knn(CQL, [1.0], [3.0], k=5, timeout_ms=60_000)
    d2, i2, _ = src.planner.knn(CQL, [1.0], [3.0], k=5)
    np.testing.assert_array_equal(d1, d2)
    np.testing.assert_array_equal(i1, i2)
    qr = src.planner.count_result(PQuery("timed", CQL))
    assert (qr.kind, qr.count, qr.approx, qr.bound, qr.confidence) == (
        "count", count, False, 0.0, 1.0)
    assert qr.version == src.storage.manifest_version()
