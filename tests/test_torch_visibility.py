"""Feature and attribute visibility on the port (`geomesa_tpu_torch.security`
and the planner's `auths` hint) against the reference's.

One catalog of `vis:String,speed:Double:visibility=admin,dtg:Date,
*geom:Point` with `geomesa.vis.attr=vis`, written by the reference from a
seed, is read by the port on the CPU. Its `vis` column draws from six
expressions and null. Under each auths set: counts (a BBOX+time+attribute
filter, and a polygon literal, whose band correction takes the visibility
mask as `extra`), features (with `speed` redacted without `admin`), sparse
and fullscan kNN, density, and the refusal of aggregations over `speed`
equal the reference's. The device gather of the allow table equals
`allow_mask`, including null and out-of-range codes. Two auths classes
with one CQL served through one ring never share a frozen mask or a
capture, and each equals its serial answer.
"""

import numpy as np
import pytest
import torch

import geomesa_tpu.serve as rserve
import geomesa_tpu_torch.serve as pserve
from geomesa_tpu.core.columnar import FeatureBatch as RFB
from geomesa_tpu.core.sft import SimpleFeatureType as RSFT
from geomesa_tpu.plan.datastore import DataStore as RDataStore
from geomesa_tpu.plan.hints import QueryHints as RHints
from geomesa_tpu.plan.query import Query as RQuery
from geomesa_tpu.security import visibility as rvis
from geomesa_tpu_torch.compilecache.registry import registry
from geomesa_tpu_torch.plan.datastore import DataStore as PDataStore
from geomesa_tpu_torch.plan.hints import QueryHints as PHints
from geomesa_tpu_torch.plan.query import Query as PQuery
from geomesa_tpu_torch.plan.runner import allow_table, gather_allow
from geomesa_tpu_torch.security import visibility as pvis
from geomesa_tpu_torch.serve.scheduler import ServeRequest

SPEC = ("vis:String,speed:Double:visibility=admin,dtg:Date,*geom:Point;"
        "geomesa.vis.attr=vis")
VOCAB = ["", "user", "admin", "admin&user", "admin|ops", "(admin|ops)&user",
         None]
AUTHS = [(), ("user",), ("admin", "user"), ("ops",)]
T0, DAY = 1_600_000_000_000, 86_400_000
N = 4096
CQL = ("BBOX(geom, -10, 35, 12.5, 55) AND dtg > 2020-09-13T13:00:00Z "
       "AND speed > 5.0")
POLY = ("INTERSECTS(geom, POLYGON((-8 36, 10 37, 11 54, -5 52, -8 36))) "
        "AND speed > 5.0")
PKG = {"ref": (RQuery, RHints), "port": (PQuery, PHints)}


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("torch_vis"))
    rng = np.random.default_rng(5)
    sft = RSFT.from_spec("sec", SPEC)
    vis = [VOCAB[i] for i in rng.integers(0, len(VOCAB), N)]
    x, y = rng.uniform(-20, 20, N), rng.uniform(30, 60, N)
    order = np.argsort(np.floor((x + 20) / 2.5) * 64 + np.floor((y - 30) / 2.5),
                       kind="stable")
    RDataStore(root, use_device_cache=True).create_schema(sft).write(
        RFB.from_pydict(sft, {
            "vis": [vis[i] for i in order],
            "speed": rng.uniform(0, 30, N)[order],
            "dtg": rng.integers(T0, T0 + 3 * DAY, N)[order],
            "geom": np.stack([x[order], y[order]], 1)}))
    return {"ref": RDataStore(root, use_device_cache=True),
            "port": PDataStore(root, use_device_cache=True, device="cpu")}


def query(pkg, cql, **kw):
    q_cls, h_cls = PKG[pkg]
    hints = {k: v for k, v in kw.items() if k not in ("max_features",)}
    return q_cls("sec", cql, hints=h_cls(**hints),
                 max_features=kw.get("max_features"))


def src(stores, pkg):
    return stores[pkg].get_feature_source("sec")


# -- the evaluator and the allow mask -----------------------------------------


def test_parser_and_evaluator_equal_reference():
    exprs = ["", None, "admin", "admin&(usa|gbr)", "a|b|c", '"weird label"&x',
             "(admin|ops)&user", "admin&user"]
    sets = [[], ["admin"], ["admin", "gbr"], ["usa", "gbr"], ["c"],
            ["weird label", "x"], ["ops", "user"]]
    pe, re_ = pvis.VisibilityEvaluator(), rvis.VisibilityEvaluator()
    for e in exprs:
        for a in sets:
            assert pe.can_see(e, a) == re_.can_see(e, a), (e, a)
    for bad in ("a&b|c", "(a", "a)", "&", "a b"):
        with pytest.raises(ValueError):
            re_.can_see(bad, ["a"])
        with pytest.raises(ValueError):
            pe.can_see(bad, ["a"])
    p = pvis.StaticAuthorizationsProvider(["a", "b"])
    assert p.get_authorizations() == ["a", "b"]


@pytest.mark.parametrize("auths", AUTHS)
def test_device_gather_equals_allow_mask(auths):
    """Fail closed: codes past the vocabulary (and -2) are denied, -1
    (null) is public; an empty vocabulary allows only nulls."""
    codes = np.array([0, 1, 2, 3, 4, 5, 6, -1, 7, 99, -2, 3], np.int32)
    for vocab in (VOCAB, []):
        want = pvis.allow_mask(vocab, codes, auths)
        np.testing.assert_array_equal(
            want, rvis.allow_mask(vocab, codes, auths))
        got = gather_allow(allow_table(vocab, auths), torch.from_numpy(codes))
        np.testing.assert_array_equal(got.numpy(), want)


# -- the store under auths ----------------------------------------------------


@pytest.mark.parametrize("auths", AUTHS)
def test_counts_equal_reference_and_oracle(stores, auths):
    from geomesa_tpu_torch.core.columnar import FeatureBatch

    rb = FeatureBatch.concat(list(src(stores, "port").storage.scan()))
    vis = np.asarray(rb.columns["vis"].decode(), dtype=object)
    truth = np.array([rvis.VisibilityEvaluator().can_see(v, auths)
                      for v in vis])
    for cql in (CQL, POLY, "INCLUDE"):
        got = {pkg: src(stores, pkg).get_count(query(pkg, cql, auths=auths))
               for pkg in PKG}
        assert got["port"] == got["ref"], cql
    x = np.asarray(rb.columns["geom"].x)
    y = np.asarray(rb.columns["geom"].y)
    sp = np.asarray(rb.columns["speed"])
    t = np.asarray(rb.columns["dtg"])
    # dtg > 2020-09-13T13:00:00Z is T0 + 3600 s (T0 is 12:26:40 UTC)
    oracle = ((x >= -10) & (x <= 12.5) & (y >= 35) & (y <= 55)
              & (t > 1_600_002_000_000) & (sp > 5.0) & truth)
    assert src(stores, "port").get_count(
        query("port", CQL, auths=auths)) == int(oracle.sum())
    assert src(stores, "port").get_count(
        query("port", "INCLUDE", auths=auths)) == int(truth.sum())


@pytest.mark.parametrize("auths", [("user",), ("admin", "user")])
def test_features_redacted_as_reference(stores, auths):
    got = {pkg: src(stores, pkg).get_features(query(
        pkg, CQL, auths=auths, max_features=50)).features for pkg in PKG}
    p, r = got["port"], got["ref"]
    assert len(p) == len(r) > 0
    np.testing.assert_array_equal(np.asarray(p.columns["speed"]),
                                  np.asarray(r.columns["speed"]))
    assert np.isnan(np.asarray(p.columns["speed"])).all() == (
        "admin" not in auths)
    np.testing.assert_array_equal(p.columns["geom"].x, r.columns["geom"].x)
    assert list(p.columns["vis"].decode()) == list(r.columns["vis"].decode())


@pytest.mark.parametrize("hints", [
    dict(stats_string="MinMax(speed)"),
    # the scan route (loose bbox), where the reference checks the weight
    dict(density_bbox=(-20.0, 30.0, 20.0, 60.0), density_width=16,
         density_height=16, density_weight="speed", loose_bbox=True),
    dict(bin_track="vis", bin_label="speed")])
def test_aggregations_over_protected_attribute_refuse(stores, hints):
    for pkg in PKG:
        with pytest.raises(PermissionError, match="speed"):
            src(stores, pkg).get_features(query(pkg, CQL, auths=("user",),
                                                **hints))
    r = src(stores, "port").get_features(query(
        "port", "INCLUDE", auths=("admin",), stats_string="MinMax(speed)"))
    assert r.kind == "stats"


def test_density_weight_refuses_on_the_cached_route(stores):
    """The cached route refuses a protected weight too. The reference
    checks the weight on its scan route only, so its cached route sums
    values the auths cannot see; the port closes that on purpose."""
    dh = dict(density_bbox=(-20.0, 30.0, 20.0, 60.0), density_width=16,
              density_height=16, density_weight="speed")
    port = src(stores, "port")
    with pytest.raises(PermissionError, match="speed"):
        port.get_features(query("port", CQL, auths=("user",), **dh))
    got = port.get_features(query("port", CQL, auths=("admin", "user"), **dh))
    ref = src(stores, "ref").get_features(
        query("ref", CQL, auths=("admin", "user"), **dh))
    np.testing.assert_allclose(np.asarray(got.grid), np.asarray(ref.grid),
                               rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("impl", ["sparse", "fullscan"])
def test_knn_and_density_equal_reference(stores, impl):
    rng = np.random.default_rng(8)
    qx, qy = rng.uniform(-8, 10, 8), rng.uniform(36, 54, 8)
    dh = dict(density_bbox=(-20.0, 30.0, 20.0, 60.0), density_width=16,
              density_height=16)
    for auths in [(), ("user",), ("admin", "user")]:
        got = {pkg: src(stores, pkg).knn(query(pkg, CQL, auths=auths), qx, qy,
                                         k=10, impl=impl) for pkg in PKG}
        for i in range(len(qx)):
            assert (set(got["port"][1][i].tolist())
                    == set(got["ref"][1][i].tolist()))
        np.testing.assert_array_equal(np.sort(got["port"][0], 1),
                                      np.sort(got["ref"][0], 1))
        grids = {pkg: src(stores, pkg).get_features(query(
            pkg, CQL, auths=auths, **dh)).grid for pkg in PKG}
        np.testing.assert_array_equal(grids["port"], grids["ref"])


# -- the ring: one CQL, two auths classes --------------------------------------


def test_two_auths_classes_never_share_a_ring_mask(stores):
    """Two kNN classes with one CQL and different auths through one ring:
    each arms its own program over its own frozen mask, every window
    equals its class's serial answer, and the classes differ."""
    registry.clear()
    classes = [("user",), ("admin", "user")]
    pts = [(1.0, 45.0), (-5.0, 40.0), (8.0, 50.0)]
    got = {}
    for pkg in PKG:
        serve = rserve if pkg == "ref" else pserve
        req_cls = (ServeRequest if pkg == "port"
                   else rserve.scheduler.ServeRequest)
        s = src(stores, pkg)
        svc = serve.QueryService(stores[pkg],
                                 serve.ServeConfig(max_wait_ms=1.0))
        try:
            for _ in range(2):
                for auths in classes:
                    for x, y in pts:
                        q = query(pkg, CQL, auths=auths)
                        res = svc.submit(req_cls(
                            kind="knn", query=q, qx=np.array([x]),
                            qy=np.array([y]), k=10)).result(timeout=300)
                        serial = s.planner.knn(q, np.array([x]),
                                               np.array([y]), k=10)
                        np.testing.assert_array_equal(res[0], serial[0])
                        np.testing.assert_array_equal(res[1], serial[1])
                        got[(pkg, auths, x)] = res
            ring = svc.stats()["pipeline"]["ring"]
        finally:
            svc.close(drain=True)
        assert ring["armed"] == 2 and ring["programs"] == 2, ring
        assert ring["fallbacks"] == {}
        assert ring["windows"] == 2 * len(classes) * len(pts)
        assert any(not np.array_equal(got[(pkg, classes[0], x)][1],
                                      got[(pkg, classes[1], x)][1])
                   for x, _ in pts)
    for key in [k for k in got if k[0] == "port"]:
        a, b = got[key], got[("ref",) + key[1:]]
        assert set(a[1][0].tolist()) == set(b[1][0].tolist())
    planner = src(stores, "port").planner
    a = planner.ring_arm(query("port", CQL, auths=classes[0]), q_padded=8, k=10)
    b = planner.ring_arm(query("port", CQL, auths=classes[1]), q_padded=8, k=10)
    assert a.capture is not b.capture
    assert a.capture.frozen is not b.capture.frozen
    assert a.mask_count != b.mask_count
    registry.clear()

