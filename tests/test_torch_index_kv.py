"""The port's key-value index store against the reference's, on the CPU.

The same seeded rows go into both packages' stores (`KVDataStore` over
the in-memory and the SQLite adapter, `DurableKVDataStore`). Held equal:
the lexicoders' bytes and order, every index's write keys and query
ranges byte for byte (S2 at the pole and the antimeridian included),
query results over the reference's CQL set (fids and rows), the
strategy's explain lines, overwrite, delete, age-off and id queries, a
durable restart (each package reopens the other's file) and the atomic
write, density/stats/arrow/bin over the KV rows, the visibility fold
after sampling on every result kind, and the fault sites: `kvstore.scan`
retried with the answers unchanged, `kvstore.write` never retried.
"""

import io

import numpy as np
import pyarrow as pa
import pytest

from geomesa_tpu import faults as rf
from geomesa_tpu.core.columnar import FeatureBatch as RFB
from geomesa_tpu.core.sft import SimpleFeatureType as RSFT
from geomesa_tpu.cql import parse_cql as rparse
from geomesa_tpu.index import DurableKVDataStore as RDurable
from geomesa_tpu.index import KVDataStore as RKV
from geomesa_tpu.index import keyspace as rks
from geomesa_tpu.index import lexicoders as rlx
from geomesa_tpu.plan.hints import QueryHints as RHints
from geomesa_tpu.plan.query import Query as RQuery
from geomesa_tpu_torch import faults as pf
from geomesa_tpu_torch.core.columnar import FeatureBatch as PFB
from geomesa_tpu_torch.core.sft import SimpleFeatureType as PSFT
from geomesa_tpu_torch.cql import parse_cql as pparse
from geomesa_tpu_torch.index import DurableKVDataStore as PDurable
from geomesa_tpu_torch.index import KVDataStore as PKV
from geomesa_tpu_torch.index import keyspace as pks
from geomesa_tpu_torch.index import lexicoders as plx
from geomesa_tpu_torch.plan.hints import QueryHints as PHints
from geomesa_tpu_torch.plan.query import Query as PQuery

SPEC = "actor:String:index=true,score:Double,count:Integer,dtg:Date,*geom:Point"
N = 400
POINT_FILTERS = [
    "BBOX(geom, -50, -40, 50, 40) AND dtg DURING 2020-06-01T00:00:00Z/2020-08-01T00:00:00Z",
    "BBOX(geom, 0, 0, 90, 60)",
    "actor = 'USA'",
    "actor IN ('FRA', 'CHN') AND score > 0",
    "count BETWEEN 10 AND 30",
    "score < -5.0",
    "actor LIKE 'U%'",
    "actor LIKE 'U_A%'",
    "BBOX(geom, -50, -40, 50, 40) AND actor = 'GBR'",
    "dtg AFTER 2020-08-10T00:00:00Z",
    "INTERSECTS(geom, POLYGON((-60 -30, 40 -45, 70 20, -10 55, -60 -30))) "
    "AND dtg DURING 2020-05-01T00:00:00Z/2020-09-01T00:00:00Z",
]
ID_FILTER = "__fid__ IN ('gdelt-3', 'gdelt-17', 'gdelt-399')"


def point_rows(n=N, seed=7):
    rng = np.random.default_rng(seed)
    return {"actor": rng.choice(["USA", "FRA", "CHN", "GBR", None], n).tolist(),
            "score": rng.uniform(-10, 10, n),
            "count": rng.integers(0, 100, n),
            "dtg": rng.integers(1_590_000_000_000, 1_600_000_000_000, n),
            "geom": np.stack([rng.uniform(-170, 170, n),
                              rng.uniform(-80, 80, n)], 1)}


def polygon_rows(n=60, seed=3):
    rng = np.random.default_rng(seed)
    geoms = []
    for _ in range(n):
        cx, cy = rng.uniform(-150, 150), rng.uniform(-70, 70)
        w, h = rng.uniform(0.5, 8, 2)
        geoms.append(f"POLYGON (({cx-w} {cy-h}, {cx+w} {cy-h}, {cx+w} {cy+h}, "
                     f"{cx-w} {cy+h}, {cx-w} {cy-h}))")
    return {"name": [f"p{i}" for i in range(n)],
            "dtg": rng.integers(1_590_000_000_000, 1_600_000_000_000, n),
            "geom": geoms}


def batches(spec, rows, name="gdelt", fids=None):
    """(ref batch, port batch) of the same rows."""
    return tuple(fb.from_pydict(sft.from_spec(name, spec), rows, fids=fids)
                 for sft, fb in ((RSFT, RFB), (PSFT, PFB)))


def stores(kind, root=None):
    """(ref store, port store): in-memory, SQLite-adapted or durable."""
    if kind == "memory":
        return RKV(), PKV(device="cpu")
    if kind == "sqlite":
        from geomesa_tpu.index import SqliteIndexAdapter as RSql
        from geomesa_tpu_torch.index import SqliteIndexAdapter as PSql

        seq = iter(range(1 << 20))
        return (RKV(adapter_factory=lambda: RSql(f"{root}/r{next(seq)}.db")),
                PKV(adapter_factory=lambda: PSql(f"{root}/p{next(seq)}.db"),
                    device="cpu"))
    return RDurable(f"{root}/r"), PDurable(f"{root}/p", device="cpu")


def rows_of(result_or_batch):
    """{fid: the row's values} of a features result (or a batch)."""
    b = getattr(result_or_batch, "features", result_or_batch)
    if b is None:
        return {}
    out = {}
    cols = []
    for name, col in b.columns.items():
        if hasattr(col, "decode"):
            cols.append(col.decode())
        elif hasattr(col, "is_point"):
            cols.append(list(zip(col.x.tolist(), col.y.tolist())))
        else:
            cols.append(np.asarray(col).tolist())
    for i, fid in enumerate(b.fids.decode()):
        out[fid] = tuple(c[i] for c in cols)
    return out


@pytest.fixture(autouse=True)
def _pristine_fabric():
    for f in (rf, pf):
        f.uninstall()
        f.BREAKERS.reset()
    yield
    for f in (rf, pf):
        f.uninstall()
        f.BREAKERS.reset()


@pytest.fixture(scope="module", params=["memory", "sqlite"])
def kv_pair(request, tmp_path_factory):
    rs, ps = stores(request.param, str(tmp_path_factory.mktemp("kv")))
    rb, pb = batches(SPEC, point_rows())
    rsrc = rs.create_schema(rb.sft)
    psrc = ps.create_schema(pb.sft)
    assert rsrc.write(rb) == psrc.write(pb)
    return rb, rsrc, psrc


# -- lexicoders --------------------------------------------------------------


@pytest.mark.parametrize("values,coder", [
    ([-(2**62), -1000, -1, 0, 1, 7, 2**40, 2**62], "int"),
    ([-1e300, -2.5, -1e-9, -0.0, 0.0, 1e-9, 1.0, 3.14, 1e300], "float"),
    (["", "a", "ab", "b", "ba", "z\x00q", "z\x01q", "zz", "é"], "string"),
])
def test_lexicoders_equal_the_reference_and_keep_order(values, coder):
    enc = [getattr(plx, f"encode_{coder}")(v) for v in values]
    assert enc == [getattr(rlx, f"encode_{coder}")(v) for v in values]
    assert [getattr(plx, f"decode_{coder}")(e) for e in enc] == values
    if coder != "string":  # strings keep order only without 0x00/0x01
        assert enc == sorted(enc)


def test_encode_value_and_successor_equal_the_reference():
    cases = [(5, "Integer"), (-5, "Long"), (2.5, "Double"), (float("nan"), "Float"),
             (None, "String"), (1_590_000_000_000, "Date"), (True, "Boolean"),
             ("abc", "String")]
    assert ([plx.encode_value(v, t) for v, t in cases]
            == [rlx.encode_value(v, t) for v, t in cases])
    for b in [b"abc", b"a\xff", b"\xff\xff", b"x", b""]:
        s = plx.successor(b)
        assert s == rlx.successor(b) and s > b and s > b + b"\xfe\xfe"


# -- keyspaces: keys and ranges byte for byte --------------------------------


def _index(mod, name, sft):
    if name == "z3":
        return mod.Z3Index(sft)
    if name == "z2":
        return mod.Z2Index(sft)
    if name == "s2":
        return mod.S2Index(sft, shards=2, level=13)
    if name == "xz2":
        return mod.XZ2Index(sft)
    if name == "xz3":
        return mod.XZ3Index(sft)
    if name == "id":
        return mod.IdIndex(sft, shards=1)
    return mod.AttributeIndex(sft, name)


RANGE_FILTERS = {
    "z3": POINT_FILTERS[0],
    "z2": "BBOX(geom, 0, 0, 90, 60)",
    "s2": "BBOX(geom, -60, 20, 60, 70)",
    "xz2": "BBOX(geom, -60, -40, -10, 10)",
    "xz3": "BBOX(geom, 100, 20, 160, 70) AND dtg DURING "
           "2020-06-01T00:00:00Z/2020-06-20T00:00:00Z",
    "id": "__fid__ IN ('f-2', 'f-9')",
    "actor": "actor IN ('FRA', 'CHN') OR actor LIKE 'U%'",
    "count": "count BETWEEN 20 AND 40",
    "score": "score > -2.5",
    "dtg": "dtg < 2020-07-01T00:00:00Z",
}


@pytest.mark.parametrize("name", list(RANGE_FILTERS))
def test_index_keys_and_ranges_are_the_references(name):
    extended = name in ("xz2", "xz3")
    spec = "name:String,dtg:Date,*geom:Polygon" if extended else SPEC
    rows = polygon_rows() if extended else point_rows(200, seed=11)
    rb, pb = batches(spec, rows)
    ridx, pidx = _index(rks, name, rb.sft), _index(pks, name, pb.sft)
    fids = [f"f-{i}" for i in range(len(rb))]
    if name == "xz3":
        # the reference's XZ3 write passes one time to XZ3SFC.index, which
        # takes the feature's start and end: both packages raise alike
        # (ROADMAP, reference caveats)
        errs = []
        for idx, b in ((ridx, rb), (pidx, pb)):
            with pytest.raises(TypeError) as e:
                idx.write_keys(b, fids, list(range(len(b))))
            errs.append(str(e.value))
        assert errs[0] == errs[1]
    else:
        rkeys = ridx.write_keys(rb, fids, list(range(len(rb))))
        pkeys = pidx.write_keys(pb, fids, list(range(len(pb))))
        assert [(k.key, k.row) for k in pkeys] == [(k.key, k.row) for k in rkeys]
    cql = RANGE_FILTERS[name]
    assert pidx.supports(pparse(cql)) == ridx.supports(rparse(cql)) is True
    assert pidx.ranges(pparse(cql)) == ridx.ranges(rparse(cql))


@pytest.mark.parametrize("cql", [
    "BBOX(geom, 150, 60, 180, 90)",     # polar and the antimeridian
    "BBOX(geom, -180, -90, -150, -70)",  # the south pole's face
    "BBOX(geom, 170, -10, 180, 10)",
    "BBOX(geom, -10, -5, 10, 5)",
])
def test_s2_polar_and_antimeridian_ranges_are_the_references(cql):
    rng = np.random.default_rng(41)
    n = 300
    rows = {"speed": rng.uniform(0, 30, n),
            "dtg": rng.integers(1_590_000_000_000, 1_600_000_000_000, n),
            "geom": np.stack([rng.uniform(-180, 180, n),
                              rng.uniform(60, 90, n) * rng.choice([-1, 1], n)], 1)}
    rb, pb = batches("speed:Double,dtg:Date,*geom:Point", rows, "ais")
    ridx = rks.S2Index(rb.sft, shards=2, level=13)
    pidx = pks.S2Index(pb.sft, shards=2, level=13)
    assert pidx.ranges(pparse(cql)) == ridx.ranges(rparse(cql))
    rs, ps = stores("memory")
    rsrc = rs.create_schema(rb.sft, indices=[ridx])
    psrc = ps.create_schema(pb.sft, indices=[pidx])
    rsrc.write(rb)
    psrc.write(pb)
    assert rows_of(psrc.get_features(cql)) == rows_of(rsrc.get_features(cql))


def test_default_indices_are_the_references():
    for spec in (SPEC, "n:Integer,*geom:LineString", "n:Integer,dtg:Date,*geom:Polygon",
                 "a:String:index=join,b:Long:index=full,*geom:Point"):
        names = [[getattr(i, "full_name", i.name) for i in mod.default_indices(
            sft.from_spec("t", spec))] for mod, sft in ((rks, RSFT), (pks, PSFT))]
        assert names[0] == names[1]


# -- queries ----------------------------------------------------------------


@pytest.mark.parametrize("cql", POINT_FILTERS)
def test_kv_query_parity(kv_pair, cql):
    _, rsrc, psrc = kv_pair
    got = rows_of(psrc.get_features(cql))
    assert got == rows_of(rsrc.get_features(cql))
    assert psrc.get_count(cql) == rsrc.get_count(cql) == len(got)


@pytest.mark.parametrize("cql", POINT_FILTERS + [ID_FILTER])
def test_kv_explain_lines_are_the_references(kv_pair, cql):
    _, rsrc, psrc = kv_pair
    assert psrc.explain(cql) == rsrc.explain(cql)


def test_kv_strategy_choice_and_override(kv_pair):
    _, rsrc, psrc = kv_pair
    assert "chose attr:actor" in psrc.explain("actor = 'USA'")
    assert "chose z" in psrc.explain(POINT_FILTERS[0])
    assert "chose z2" in psrc.explain("BBOX(geom, 0, 0, 90, 60)")
    assert "Index override: id" in psrc.explain(PQuery(
        "gdelt", ID_FILTER, hints=PHints(query_index="id")))
    for idx in ("z2", "z3", "attr:actor", "nope"):
        rq = RQuery("gdelt", POINT_FILTERS[8], hints=RHints(query_index=idx))
        pq = PQuery("gdelt", POINT_FILTERS[8], hints=PHints(query_index=idx))
        assert psrc.plan(pq)[2].name == rsrc.plan(rq)[2].name
        assert psrc.get_count(pq) == rsrc.get_count(rq)


def test_kv_fid_filter_plans_on_the_id_index_as_the_reference(kv_pair):
    """An `__fid__` filter plans on the id index, and its residual does
    not compile in either package (ROADMAP, reference caveats): fid
    lookups go through get_features_by_id."""
    _, rsrc, psrc = kv_pair
    for src in (rsrc, psrc):
        assert src.plan(ID_FILTER)[2].ranges == [
            (b"gdelt-17", b"gdelt-17\x00"), (b"gdelt-3", b"gdelt-3\x00"),
            (b"gdelt-399", b"gdelt-399\x00")]
    errs = []
    for src in (rsrc, psrc):
        with pytest.raises(ValueError) as e:
            src.get_count(ID_FILTER)
        errs.append(str(e.value))
    assert errs[0] == errs[1]
    ids = ["gdelt-3", "gdelt-17", "gdelt-399"]
    assert rows_of(psrc.get_features_by_id(ids)) == rows_of(
        rsrc.get_features_by_id(ids))


@pytest.mark.parametrize("kind", ["density", "stats", "arrow", "bin", "sample"])
def test_kv_aggregations_are_the_references(kv_pair, kind):
    _, rsrc, psrc = kv_pair
    cql = "BBOX(geom, -50, -40, 50, 40)"
    h = {"density": dict(density_bbox=(-50, -40, 50, 40), density_width=16,
                         density_height=16, density_weight="score"),
         "stats": dict(stats_string="Count();MinMax(score);Histogram(count,10,0,100)"),
         "arrow": dict(arrow_encode=True),
         "bin": dict(bin_track="actor"),
         "sample": dict(sampling=3, sample_by="actor")}[kind]
    r = rsrc.get_features(RQuery("gdelt", cql, hints=RHints(**h)))
    p = psrc.get_features(PQuery("gdelt", cql, hints=PHints(**h)))
    assert p.kind == r.kind
    if kind == "density":
        np.testing.assert_allclose(p.grid, r.grid, rtol=1e-5, atol=1e-4)
        assert p.count == r.count
    elif kind == "stats":
        assert ([s.to_json() for s in p.stats.stats]
                == [s.to_json() for s in r.stats.stats])
    elif kind == "arrow":
        pt = pa.ipc.open_stream(io.BytesIO(p.arrow_bytes)).read_all()
        rt = pa.ipc.open_stream(io.BytesIO(r.arrow_bytes)).read_all()
        assert pt.equals(rt) and pt.num_rows == p.count
    elif kind == "bin":
        assert p.bin_bytes == r.bin_bytes
    else:
        assert rows_of(p) == rows_of(r)


@pytest.mark.parametrize("kind", ["memory", "sqlite"])
def test_kv_overwrite_delete_age_off_and_ids(tmp_path, kind):
    rs, ps = stores(kind, str(tmp_path))
    rb, pb = batches(SPEC, point_rows(120, seed=23))
    rsrc, psrc = rs.create_schema(rb.sft), ps.create_schema(pb.sft)
    fids = psrc.write(pb)
    assert fids == rsrc.write(rb)
    # same fids again replace, never duplicate
    assert psrc.write(pb, fids=fids) == rsrc.write(rb, fids=fids)
    assert psrc.live_count == rsrc.live_count == 120
    assert (psrc.delete_features("actor = 'USA'")
            == rsrc.delete_features("actor = 'USA'") > 0)
    now, ttl = 1_600_000_000_000, 5_000_000_000
    assert psrc.age_off(ttl, now_ms=now) == rsrc.age_off(ttl, now_ms=now) > 0
    assert psrc.live_count == rsrc.live_count
    for cql in ("INCLUDE", "BBOX(geom, -180, -90, 180, 90)", "actor = 'USA'",
                POINT_FILTERS[3]):
        assert rows_of(psrc.get_features(cql)) == rows_of(rsrc.get_features(cql))
    some = [fids[3], fids[17], fids[29], "missing"]
    assert rows_of(psrc.get_features_by_id(some)) == rows_of(
        rsrc.get_features_by_id(some))
    assert len(psrc.get_features_by_id(["missing"])) == 0


def test_kv_extended_geometries(tmp_path):
    rows = polygon_rows()
    del rows["dtg"]  # with a dtg the default set holds XZ3, which cannot write
    rb, pb = batches("name:String,*geom:Polygon", rows, "polys")
    rs, ps = stores("memory")
    rsrc, psrc = rs.create_schema(rb.sft), ps.create_schema(pb.sft)
    rsrc.write(rb)
    psrc.write(pb)
    for cql in ("BBOX(geom, -60, -40, -10, 10)", "BBOX(geom, 100, 20, 160, 70)",
                "INTERSECTS(geom, POLYGON((-60 -30, 40 -45, 70 20, -10 55, -60 -30)))"):
        assert psrc.explain(cql) == rsrc.explain(cql)
        assert rows_of(psrc.get_features(cql)) == rows_of(rsrc.get_features(cql))


# -- durability ---------------------------------------------------------------


def test_durable_restart_reopens_across_packages(tmp_path):
    rs, ps = stores("durable", str(tmp_path))
    rb, pb = batches(SPEC, point_rows(120, seed=29))
    rsrc, psrc = rs.create_schema(rb.sft), ps.create_schema(pb.sft)
    fids = psrc.write(pb)
    rsrc.write(rb)
    psrc.delete_features("actor = 'USA'")
    rsrc.delete_features("actor = 'USA'")
    rs.close()
    ps.close()
    # each package reopens its own file and the other's
    opened = [RDurable(str(tmp_path / "r")), PDurable(str(tmp_path / "p"), device="cpu"),
              RDurable(str(tmp_path / "p")), PDurable(str(tmp_path / "r"), device="cpu")]
    want = {cql: rows_of(opened[0].get_feature_source("gdelt").get_features(cql))
            for cql in POINT_FILTERS}
    for ds in opened:
        assert ds.get_type_names() == ["gdelt"]
        src = ds.get_feature_source("gdelt")
        assert src.sft.to_spec() == rb.sft.to_spec()
        for cql, rows in want.items():
            assert rows_of(src.get_features(cql)) == rows, cql
        live = [f for f in fids if f in src._fid_row][:5]
        assert sorted(src.get_features_by_id(live).fids.decode()) == sorted(live)
    for ds in opened:
        ds.close()


def test_durable_write_is_atomic(tmp_path):
    """A failure before the last index write rolls the whole logical
    write back on disk: the reopened store is the one before it."""
    ds = PDurable(str(tmp_path / "kv"), device="cpu")
    rb, pb = batches(SPEC, point_rows(40, seed=31))
    src = ds.create_schema(pb.sft)
    fids = src.write(pb)
    real_write, calls = src.adapter.write, []

    def flaky(name, keys):
        calls.append(name)
        if len(calls) == len(src.indices):
            raise RuntimeError("simulated crash")
        real_write(name, keys)

    src.adapter.write = flaky
    with pytest.raises(RuntimeError):
        src.write(pb, fids=fids)
    src.adapter.write = real_write
    ds.close()
    rs = RKV()
    rsrc = rs.create_schema(rb.sft)
    rsrc.write(rb)
    src2 = PDurable(str(tmp_path / "kv"), device="cpu").get_feature_source("gdelt")
    assert src2.live_count == 40
    for cql in POINT_FILTERS:
        assert rows_of(src2.get_features(cql)) == rows_of(rsrc.get_features(cql))


# -- visibility: folded after sampling, on every result kind -------------------

VIS_SPEC = ("name:String:index=true,vis:String,score:Double,dtg:Date,*geom:Point;"
            "geomesa.vis.attr=vis")


@pytest.fixture(scope="module")
def vis_pair():
    rng = np.random.default_rng(11)
    n = 90
    rows = {"name": rng.choice(["a", "b"], n).tolist(),
            "vis": (["admin"] * 30 + ["admin&usa"] * 30 + [None] * 30),
            "score": rng.uniform(0, 9, n),
            "dtg": rng.integers(1_590_000_000_000, 1_600_000_000_000, n),
            "geom": np.stack([rng.uniform(-170, 170, n), rng.uniform(-80, 80, n)], 1)}
    rb, pb = batches(VIS_SPEC, rows, "sec", fids=[f"s{i}" for i in range(n)])
    rs, ps = stores("memory")
    rsrc, psrc = rs.create_schema(rb.sft), ps.create_schema(pb.sft)
    rsrc.write(rb)
    psrc.write(pb)
    protected = {f"s{i}" for i in range(60)}
    return rsrc, psrc, protected


@pytest.mark.parametrize("kind", ["features", "count", "sampled", "density",
                                  "stats", "arrow", "bin"])
def test_kv_visibility_folds_after_sampling(vis_pair, kind):
    rsrc, psrc, protected = vis_pair
    h = {"features": {}, "count": {}, "sampled": dict(sampling=2),
         "density": dict(density_bbox=(-180, -90, 180, 90), density_width=8,
                         density_height=8),
         "stats": dict(stats_string="Count()"), "arrow": dict(arrow_encode=True),
         "bin": dict(bin_track="name")}[kind]
    cql = "name IN ('a', 'b')"  # the attribute index, then the residual
    for auths, hidden in (((), protected), (("admin",), {f"s{i}" for i in range(30, 60)}),
                          (("admin", "usa"), set())):
        rq = RQuery("sec", cql, hints=RHints(auths=auths, **h))
        pq = PQuery("sec", cql, hints=PHints(auths=auths, **h))
        if kind == "count":
            got = psrc.get_count(pq)
            assert got == rsrc.get_count(rq) == 90 - len(hidden)
            continue
        r, p = rsrc.get_features(rq), psrc.get_features(pq)
        assert p.kind == r.kind
        if kind in ("features", "sampled"):
            assert rows_of(p) == rows_of(r)
            assert not set(rows_of(p)) & hidden
        elif kind == "density":
            np.testing.assert_array_equal(p.grid, r.grid)
            assert p.grid.sum() == 90 - len(hidden)
        elif kind == "stats":
            assert p.stats.stats[0].result() == r.stats.stats[0].result()
            assert p.count == 90 - len(hidden)
        elif kind == "arrow":
            t = pa.ipc.open_stream(io.BytesIO(p.arrow_bytes)).read_all()
            assert t.equals(pa.ipc.open_stream(io.BytesIO(r.arrow_bytes)).read_all())
            assert not set(t.column("__fid__").to_pylist()) & hidden
        else:
            assert p.bin_bytes == r.bin_bytes and p.count == 90 - len(hidden)


# -- fault sites ---------------------------------------------------------------


def test_kv_scan_fault_retries_and_the_answers_are_unchanged(kv_pair):
    _, rsrc, psrc = kv_pair
    cqls = POINT_FILTERS[:4] + POINT_FILTERS[8:]
    clean = [rows_of(psrc.get_features(c)) for c in cqls]
    out = {}
    for name, f, src, rule in (("ref", rf, rsrc, rf.FaultRule),
                               ("port", pf, psrc, pf.FaultRule)):
        plan = f.FaultPlan(seed=5, rules=[rule(site="kvstore.scan", error="io",
                                                every=2)])
        tok = f.RECOVERY.token()
        with f.active(plan) as h:
            got = [rows_of(src.get_features(c)) for c in cqls]
            log = h.fire_log()
        retries = [k for k, _ in f.RECOVERY.since(tok) if k == "retry"]
        assert got == clean and log and len(retries) == len(log)
        out[name] = log
    assert out["port"] == out["ref"]


def test_kv_write_fault_propagates_and_is_not_retried():
    out = {}
    for name, f, ds, fb in (("ref", rf, RKV(), RFB), ("port", pf, PKV(device="cpu"), PFB)):
        rb = fb.from_pydict((RSFT if name == "ref" else PSFT).from_spec("gdelt", SPEC),
                            point_rows(20))
        src = ds.create_schema(rb.sft)
        plan = f.FaultPlan(rules=[f.FaultRule(site="kvstore.write", error="io",
                                              every=1)])
        tok = f.RECOVERY.token()
        with f.active(plan) as h:
            with pytest.raises(OSError) as err:
                src.write(rb)
            log = h.fire_log()
        assert not [k for k, _ in f.RECOVERY.since(tok) if k == "retry"]
        out[name] = (log, type(err.value).__name__, src.get_count("INCLUDE"))
    assert out["port"] == out["ref"] and len(out["port"][0]) == 1
