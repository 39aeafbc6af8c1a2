"""The BIN and Arrow codecs: the port's `engine/bin.py` and
`core/arrow_io.py` against the reference package's, and the runner's bin
and arrow results through both packages' DataStore over one catalog the
reference writes.

Held: BIN bytes identical (pre-1970 dates floor to the second below, NaN
and -0.0 keep their bit patterns, int64 labels split low word first);
Arrow IPC bytes identical (both packages use the same pyarrow, and the
encoding is deterministic), sorted DELTA batches and their merge
identical, the IPC file round trip lossless; a query's bin and arrow
results identical on the cached and the scan route, also when nothing
matches.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from geomesa_tpu.core import arrow_io as rai
from geomesa_tpu.core.columnar import FeatureBatch as RFB
from geomesa_tpu.core.sft import SimpleFeatureType as RSFT
from geomesa_tpu.engine import bin as rbin
from geomesa_tpu.plan import DataStore as RDS, Query as RQ, QueryHints as RH
from geomesa_tpu_torch.core import arrow_io as pai
from geomesa_tpu_torch.core.columnar import FeatureBatch as PFB
from geomesa_tpu_torch.core.sft import SimpleFeatureType as PSFT
from geomesa_tpu_torch.engine import bin as pbin
from geomesa_tpu_torch.plan import DataStore as PDS, Query as PQ, QueryHints as PH

SPEC = "vessel:String,kind:Integer,speed:Double,dtg:Date,*geom:Point"
POLY_SPEC = "name:String,dtg:Date,*geom:Polygon"
T0 = 1_600_000_000_000
N = 2000


def lanes(n=N, seed=31):
    rng = np.random.default_rng(seed)
    track = rng.integers(-2**31, 2**31 - 1, n).astype(np.int32)
    dtg = rng.integers(-5 * 10**11, 2 * 10**12, n)
    dtg[:4] = [-1, -999, -1000, -1001]  # floor division below 1970
    lat = rng.uniform(-90, 90, n).astype(np.float32)
    lon = rng.uniform(-180, 180, n).astype(np.float32)
    lat[:3] = [np.nan, -0.0, np.float32(np.inf)]
    lon[3] = -0.0
    label = rng.integers(-2**62, 2**62, n)
    label[:2] = [2**40 + 7, -(2**33) - 1]
    return track, dtg, lat, lon, label


@pytest.mark.parametrize("labeled", [False, True])
def test_bin_bytes_identical(labeled):
    track, dtg, lat, lon, label = lanes()
    sel = np.sort(np.random.default_rng(1).choice(N, 700, replace=False))
    r = rbin.encode_bin(rbin.bin_pack(
        jnp.asarray(track), jnp.asarray(dtg), jnp.asarray(lat), jnp.asarray(lon),
        label=jnp.asarray(label) if labeled else None), sel)
    t = torch.from_numpy
    p = pbin.encode_bin(pbin.bin_pack(
        t(track), t(dtg), t(lat), t(lon), label=t(label) if labeled else None), sel)
    assert p == r and len(p) == 700 * (24 if labeled else 16)
    dec = pbin.decode_bin(p, labeled=labeled)
    assert dec.tobytes() == rbin.decode_bin(r, labeled=labeled).tobytes()
    np.testing.assert_array_equal(dec["dtg_s"], np.floor_divide(dtg[sel], 1000))
    np.testing.assert_array_equal(dec["lat"].view(np.int32), lat[sel].view(np.int32))
    if labeled:
        np.testing.assert_array_equal(dec["label"], label[sel])
    full = pbin.decode_bin(pbin.encode_bin(pbin.bin_pack(
        t(track), t(dtg), t(lat), t(lon))))
    assert full["dtg_s"][:4].tolist() == [-1, -1, -1, -2]
    assert np.isnan(full["lat"][0]) and np.signbit(full["lat"][1])
    assert np.signbit(full["lon"][3])


def batches(n=300, seed=2):
    rng = np.random.default_rng(seed)
    cols = {"vessel": rng.choice(["a", "b", "c", None], n).tolist(),
            "kind": rng.integers(0, 9, n).astype(np.int32),
            "speed": rng.uniform(0, 30, n),
            "dtg": T0 + rng.integers(0, 86_400_000, n),
            "geom": np.stack([rng.uniform(-10, 10, n), rng.uniform(40, 50, n)], 1)}
    fids = [f"f{i}" for i in range(n)]
    rb = RFB.from_pydict(RSFT.from_spec("ais", SPEC), cols, fids=fids)
    pb = PFB.from_pydict(PSFT.from_spec("ais", SPEC), cols, fids=fids)
    polys = [f"POLYGON (({x} {y}, {x + 1} {y}, {x} {y + 1}, {x} {y}), "
             f"({x + 0.1} {y + 0.1}, {x + 0.2} {y + 0.1}, {x + 0.1} {y + 0.2}, "
             f"{x + 0.1} {y + 0.1}))" for x, y in rng.uniform(0, 5, (20, 2))]
    pcols = {"name": [f"p{i}" for i in range(20)],
             "dtg": T0 + np.arange(20) * 1000, "geom": polys}
    return (rb, pb, RFB.from_pydict(RSFT.from_spec("r", POLY_SPEC), pcols),
            PFB.from_pydict(PSFT.from_spec("r", POLY_SPEC), pcols))


def test_arrow_bytes_and_round_trips(tmp_path):
    rb, pb, rpoly, ppoly = batches()
    for r, p in ((rb, pb), (rpoly, ppoly)):
        assert pai.arrow_schema(p.sft) == rai.arrow_schema(r.sft)
        assert pai.to_ipc_bytes(p) == rai.to_ipc_bytes(r)
        back = list(pai.ipc_feature_batches(pai.to_ipc_bytes(p)))
        assert len(back) == 1 and back[0].sft.to_spec() == p.sft.to_spec()
        assert pai.to_ipc_bytes(back[0]) == pai.to_ipc_bytes(p)
        path = str(tmp_path / f"{p.sft.name}.arrow")
        pai.write_ipc(path, [p, p.select(np.arange(5))])
        got = pai.read_ipc(path)
        assert [len(b) for b in got] == [len(p), 5]
        assert rai.to_ipc_bytes(rai.read_ipc(path)[0]) == pai.to_ipc_bytes(got[0])
    for field, rev in (("speed", False), ("vessel", True), ("dtg", False)):
        parts_p = [pai.to_sorted_ipc_bytes(pb.select(np.arange(i, 300, 3)), field, rev)
                   for i in range(3)]
        parts_r = [rai.to_sorted_ipc_bytes(rb.select(np.arange(i, 300, 3)), field, rev)
                   for i in range(3)]
        assert parts_p == parts_r
        assert pai.merge_sorted_ipc(parts_p) == rai.merge_sorted_ipc(parts_r)
    with pytest.raises(ValueError, match="geometry"):
        pai.to_sorted_ipc_bytes(pb, "geom")
    with pytest.raises(ValueError, match="sort metadata"):
        pai.merge_sorted_ipc([pai.to_ipc_bytes(pb)])


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("torch_codecs"))
    rb, _, rpoly, _ = batches(n=3000)
    RDS(root).create_schema(rb.sft).write(rb)
    RDS(root).create_schema(rpoly.sft).write(rpoly)
    return ((RDS(root), PDS(root, device="cpu")),
            (RDS(root, use_device_cache=True),
             PDS(root, use_device_cache=True, device="cpu")))


CQL = "BBOX(geom, -5, 42, 6, 49) AND speed > 7"
HINTS = [
    dict(bin_track="vessel"),
    dict(bin_track="vessel", bin_label="kind"),
    dict(bin_track="kind", sampling=3),
    dict(arrow_encode=True),
    dict(arrow_encode=True, arrow_include_fid=False),
    dict(arrow_encode=True, arrow_sort_field="dtg"),
    dict(arrow_encode=True, arrow_sort_field="speed", arrow_sort_reverse=True),
    dict(arrow_encode=True, loose_bbox=True),
]


@pytest.mark.parametrize("hints", HINTS, ids=[",".join(h) for h in HINTS])
@pytest.mark.parametrize("cql", [CQL, "speed > 1000"])
def test_runner_bin_and_arrow(stores, hints, cql):
    """Each route against the reference's same route: with no match, the
    scan route encodes the scanned batch's empty selection (its string
    vocabularies ride along), the cached route the empty result."""
    for rds, pds in stores:
        r = rds.get_feature_source("ais").get_features(RQ("ais", cql, hints=RH(**hints)))
        p = pds.get_feature_source("ais").get_features(PQ("ais", cql, hints=PH(**hints)))
        assert p.kind == r.kind
        if p.kind == "bin":
            assert p.bin_bytes == r.bin_bytes and p.count == r.count
        else:
            assert p.arrow_bytes == r.arrow_bytes
        if cql == CQL:
            assert (r.bin_bytes or r.arrow_bytes)


def test_polygon_layer_arrow(stores):
    cql = "INTERSECTS(geom, POLYGON ((0 0, 3 0, 3 3, 0 3, 0 0)))"
    q = dict(arrow_encode=True, arrow_include_fid=False)
    for rds, pds in stores:
        r = rds.get_feature_source("r").get_features(RQ("r", cql, hints=RH(**q)))
        p = pds.get_feature_source("r").get_features(PQ("r", cql, hints=PH(**q)))
        assert p.kind == "arrow" and p.arrow_bytes == r.arrow_bytes
    (back,) = list(pai.ipc_feature_batches(r.arrow_bytes))
    assert 0 < len(back) < 20


@pytest.mark.cuda
def test_bin_pack_on_the_card_matches_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    track, dtg, lat, lon, label = (torch.from_numpy(a) for a in lanes())
    cpu = pbin.bin_pack(track, dtg, lat, lon, label=label)
    dev = torch.device("cuda")
    gpu = pbin.bin_pack(*(a.to(dev) for a in (track, dtg, lat, lon)),
                        label=label.to(dev))
    assert pbin.encode_bin(gpu) == pbin.encode_bin(cpu)


@pytest.mark.cuda
def test_card_store_results_match_cpu(stores):
    """A card store's bin and arrow results equal the CPU store's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _, (_, pcpu) = stores
    gpu = PDS(pcpu.catalog, use_device_cache=True)
    for hints in HINTS:
        q = PQ("ais", CQL, hints=PH(**hints))
        a = gpu.get_feature_source("ais").get_features(q)
        b = pcpu.get_feature_source("ais").get_features(q)
        assert (a.bin_bytes, a.arrow_bytes) == (b.bin_bytes, b.arrow_bytes), hints
