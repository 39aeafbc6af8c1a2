"""The port's ingest/export jobs (`geomesa_tpu_torch.jobs`) and Arrow store
(`geomesa_tpu_torch.store.arrow_store`) against the reference's.

`ingest_files` runs GDELT TSV files through `GDELT_CONVERTER` on parallel
workers into each package's own store: the reports (files converted,
failed, skipped on resume, features, record failures) and the stored
features by id are equal, a file that fails is isolated, and a resumed
run skips every file already ingested. `export_partitions` with a
polygon filter exports, partition by partition, the rows the reference
exports through `mask_refined`, which equal an f64 host evaluation even
for points placed within 1e-7 degrees of the polygon's edges.
`ArrowDataStore` over one IPC file answers counts, features and kNN as
the reference's does, and appends round-trip.
"""

import os
import threading

import numpy as np
import pytest

from geomesa_tpu import jobs as rjobs
from geomesa_tpu.convert import converter_from_config as r_converter
from geomesa_tpu.convert.schemas import GDELT_CONVERTER as R_GDELT
from geomesa_tpu.convert.schemas import GDELT_SFT as R_GDELT_SFT
from geomesa_tpu.core.columnar import FeatureBatch as RFB
from geomesa_tpu.core.sft import SimpleFeatureType as RSFT
from geomesa_tpu.cql import compile_filter as r_compile
from geomesa_tpu.cql import parse_cql as r_parse
from geomesa_tpu.engine.device import to_device as r_to_device
from geomesa_tpu.plan.datastore import DataStore as RDataStore
from geomesa_tpu.store.arrow_store import ArrowDataStore as RArrow
from geomesa_tpu_torch import jobs as pjobs
from geomesa_tpu_torch.convert import converter_from_config as p_converter
from geomesa_tpu_torch.convert.schemas import GDELT_CONVERTER as P_GDELT
from geomesa_tpu_torch.convert.schemas import GDELT_SFT as P_GDELT_SFT
from geomesa_tpu_torch.core.arrow_io import write_ipc
from geomesa_tpu_torch.core.columnar import FeatureBatch as PFB
from geomesa_tpu_torch.core.sft import SimpleFeatureType as PSFT
from geomesa_tpu_torch.cql import compile_filter as p_compile
from geomesa_tpu_torch.cql import parse_cql as p_parse
from geomesa_tpu_torch.cql.hosteval import eval_filter_host
from geomesa_tpu_torch.engine.device import to_device as p_to_device
from geomesa_tpu_torch.plan.datastore import DataStore as PDataStore
from geomesa_tpu_torch.store.arrow_store import ArrowDataStore as PArrow

POLY = [(-8.0, 36.0), (10.0, 37.0), (11.0, 54.0), (-5.0, 52.0), (-8.0, 36.0)]
POLY_CQL = ("INTERSECTS(geom, POLYGON((" +
            ", ".join(f"{x} {y}" for x, y in POLY) + ")))")


def gdelt_file(path, n, seed, bad_every=0):
    """A GDELT 1.0 events TSV (57 columns) of `n` seeded events."""
    rng = np.random.default_rng(seed)
    lat = rng.uniform(30, 60, n)
    lon = rng.uniform(-20, 20, n)
    day = 20200601 + rng.integers(0, 4, n)
    lines = []
    for i in range(n):
        cols = [""] * 57
        cols[0], cols[1] = f"{seed}{i:06d}", str(day[i])
        cols[6] = ("USA", "", "FRANCE")[i % 3]
        cols[16] = ("", "GOV")[i % 2]
        cols[26], cols[30], cols[31] = f"{i % 190 + 10:03d}", \
            f"{rng.uniform(-10, 10):.1f}", str(i % 40)
        cols[53], cols[54] = f"{lat[i]:.5f}", f"{lon[i]:.5f}"
        if bad_every and i % bad_every == 7:
            cols[53] = "n/a"
        lines.append("\t".join(cols))
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return path


def by_fid(batch):
    fid = [batch.fids.vocab[c] for c in batch.fids.codes]
    g = batch.columns["geom"]
    a1 = batch.columns["Actor1Name"]
    return {f: (float(g.x[i]), float(g.y[i]), int(batch.columns["dtg"][i]),
                float(batch.columns["GoldsteinScale"][i]),
                a1.vocab[a1.codes[i]])
            for i, f in enumerate(fid)}


def report(rep):
    base = lambda p: os.path.basename(p.split(":")[0])  # noqa: E731
    return (sorted(map(base, rep.files_ok)), sorted(map(base, rep.files_failed)),
            rep.features, sorted(map(base, rep.skipped)), rep.records_failed)


def test_ingest_files_parallel_resume_and_isolation(tmp_path):
    files = [gdelt_file(str(tmp_path / f"g{i}.tsv"), 1500, i, bad_every=97)
             for i in range(4)]
    files.append(str(tmp_path / "missing.tsv"))  # fails alone
    out = {}
    for name, ds, jobs, conv, sft, cfg in (
            ("ref", RDataStore(str(tmp_path / "r")), rjobs, r_converter,
             R_GDELT_SFT, R_GDELT),
            ("port", PDataStore(str(tmp_path / "p"), device="cpu"), pjobs,
             p_converter, P_GDELT_SFT, P_GDELT)):
        src = ds.create_schema(sft)
        first = jobs.ingest_files(src, lambda: conv(sft, cfg), files,
                                  workers=3)
        again = jobs.ingest_files(src, lambda: conv(sft, cfg), files,
                                  workers=3)
        with pytest.raises(FileNotFoundError):
            jobs.ingest_files(src, lambda: conv(sft, cfg), files[-1:],
                              on_error="raise")
        out[name] = (report(first), report(again), src.storage.count,
                     by_fid(src.storage.read_all()),
                     src.get_count("BBOX(geom, -10, 35, 10, 55)"))
    assert out["port"] == out["ref"]
    first, again = out["port"][:2]
    assert first[0] == [f"g{i}.tsv" for i in range(4)]
    assert first[1] == ["missing.tsv"] and first[4] > 0
    assert again[3] == first[0] and again[2] == 0  # resume skipped them
    assert out["port"][2] == first[2] == 4 * 1500 - first[4]


def stores_with_edge_points(tmp_path):
    """Each package's store of the same rows: uniform points plus points
    within 1e-7 degrees of the polygon's edges (inside and outside)."""
    rng = np.random.default_rng(4)
    n = 4000
    x, y = rng.uniform(-20, 20, n), rng.uniform(30, 60, n)
    e = rng.integers(0, len(POLY) - 1, 600)
    t = rng.uniform(0, 1, 600)
    (x1, y1), (x2, y2) = np.array(POLY[:-1]).T, np.array(POLY[1:]).T
    ex = x1[e] + t * (x2[e] - x1[e]) + rng.choice([-1e-7, 1e-7, 0.0], 600)
    ey = y1[e] + t * (y2[e] - y1[e]) + rng.choice([-1e-7, 1e-7, 0.0], 600)
    x, y = np.concatenate([x, ex]), np.concatenate([y, ey])
    m = len(x)
    data = {"speed": rng.uniform(0, 30, m),
            "dtg": 1_600_000_000_000 + rng.integers(0, 3 * 86400_000, m),
            "geom": np.stack([x, y], 1)}
    fids = [f"p{i}" for i in range(m)]
    spec = "speed:Double,dtg:Date,*geom:Point"
    out = {}
    for name, ds, sft_cls, fb in (
            ("ref", RDataStore(str(tmp_path / "r")), RSFT, RFB),
            ("port", PDataStore(str(tmp_path / "p"), device="cpu"), PSFT, PFB)):
        sft = sft_cls.from_spec("pts", spec)
        src = ds.create_schema(sft)
        src.write(fb.from_pydict(sft, data, fids=fids))
        out[name] = src
    return out


def test_export_partitions_with_a_polygon_matches_through_mask_refined(tmp_path):
    stores = stores_with_edge_points(tmp_path)
    got = {}
    for name, jobs in (("ref", rjobs), ("port", pjobs)):
        parts, lock = {}, threading.Lock()

        def writer(pname, batch, parts=parts, lock=lock):
            with lock:
                parts[pname] = sorted(batch.fids.vocab[c]
                                      for c in batch.fids.codes)

        kw = {"device": "cpu"} if name == "port" else {}
        exported = jobs.export_partitions(stores[name], writer, POLY_CQL,
                                          workers=3, **kw)
        got[name] = (exported, parts)
    assert got["port"] == got["ref"]
    # the export equals the f64 host evaluation, band rows included
    src = stores["port"]
    oracle = {}
    for pname in src.storage.partitions():
        b = next(src.storage.scan_partitions([pname]))
        hit = eval_filter_host(p_parse(POLY_CQL), b)
        if hit.any():
            oracle[pname] = sorted(b.fids.vocab[c] for c in b.fids.codes[hit])
    assert got["port"][1] == oracle


def test_mask_refined_equals_the_reference(tmp_path):
    stores = stores_with_edge_points(tmp_path)
    rb = stores["ref"].storage.read_all()
    pb = stores["port"].storage.read_all()
    rm = np.asarray(r_compile(r_parse(POLY_CQL), rb.sft).mask_refined(
        r_to_device(rb), rb))
    pf = p_compile(p_parse(POLY_CQL), pb.sft)
    import torch

    pdv = p_to_device(pb, torch.device("cpu"))
    pm = pf.mask_refined(pdv, pb)
    raw = pf.mask(pdv, pb).numpy()
    np.testing.assert_array_equal(pm, rm)
    np.testing.assert_array_equal(pm, eval_filter_host(p_parse(POLY_CQL), pb))
    assert (raw != pm).sum() > 0 and pf.band(pdv, pb).sum() > 0


def test_arrow_store_round_trip_and_queries(tmp_path):
    rng = np.random.default_rng(12)
    n = 5000
    spec = "name:String,speed:Double,dtg:Date,*geom:Point"
    data = {"name": rng.choice(["a", "b", "c"], n).tolist(),
            "speed": rng.uniform(0, 30, n),
            "dtg": 1_600_000_000_000 + rng.integers(0, 86400_000, n),
            "geom": np.stack([rng.uniform(-20, 20, n),
                              rng.uniform(30, 60, n)], 1)}
    sft = PSFT.from_spec("arrowed", spec)
    path = str(tmp_path / "arrowed.arrow")
    write_ipc(path, [PFB.from_pydict(sft, data, fids=[f"a{i}" for i in range(n)])])
    port = PArrow(path, device="cpu")
    ref = RArrow(path)
    assert port.get_type_names() == ref.get_type_names() == ["arrowed"]
    psrc, rsrc = port.get_feature_source(), ref.get_feature_source("arrowed")
    cqls = ["INCLUDE", "BBOX(geom, -10, 35, 10, 55) AND speed > 5",
            POLY_CQL, "name = 'b' AND dtg > 2020-09-13T20:00:00Z"]
    for cql in cqls:
        assert psrc.get_count(cql) == rsrc.get_count(cql), cql
    pf = psrc.get_features(cqls[1]).features
    rf = rsrc.get_features(cqls[1]).features
    assert sorted(pf.fids.vocab[c] for c in pf.fids.codes) == \
        sorted(rf.fids.vocab[c] for c in rf.fids.codes)
    qx, qy = np.array([0.0, 5.0]), np.array([45.0, 40.0])
    pd, pi, pb = psrc.knn(cqls[1], qx, qy, k=5)
    rd, ri, rb = rsrc.knn(cqls[1], qx, qy, k=5)
    np.testing.assert_allclose(np.sort(pd, 1), np.sort(np.asarray(rd), 1),
                               rtol=1e-4, atol=1.0)
    assert [sorted(pb.fids.vocab[pb.fids.codes[j]] for j in row) for row in pi] \
        == [sorted(rb.fids.vocab[rb.fids.codes[j]] for j in row)
            for row in np.asarray(ri)]
    # an append rewrites the stream; both packages re-read it
    psrc.write(PFB.from_pydict(sft, {k: v[:100] for k, v in data.items()},
                               fids=[f"b{i}" for i in range(100)]))
    assert len(psrc) == n + 100
    assert RArrow(path).get_feature_source().get_count(cqls[1]) == \
        psrc.get_count(cqls[1]) == PArrow(str(tmp_path), device="cpu") \
        .get_feature_source("arrowed").get_count(cqls[1])
    with pytest.raises(ValueError):
        psrc.add_features(PFB.from_pydict(PSFT.from_spec("x", "*geom:Point"),
                                          {"geom": np.zeros((1, 2))}))
