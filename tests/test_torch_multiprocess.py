"""The port's store, served kNN and sharded engine over a mesh that spans
processes, on the CPU.

Two ranks (`tests/torch_mp_ranks.py`, gloo over a `file://` init), each
driving two `cpu` shards of one global mesh of four, run a store of 4
day partitions x 256 rows shaped like tests/test_mesh_serve.py's (so
partition i lives on shard i alone) and the engine's sharded functions
on seeded inputs. Every merged answer must be the same in both ranks and
bit-identical to the port's one-process mesh of four `cpu` shards over a
copy of the same files (and its sharded results shard for shard); the
store's counts, density and kNN must equal the reference's mesh store
over the first 4 of the 8 CPU devices tests/conftest.py forces
(neighbour sets identical, meters bit-identical, counts exact). The
ranks are spawned once for the file; every test reads their answers.
"""

import shutil
from types import SimpleNamespace

import jax
import numpy as np
import pytest

import torch_mp_ranks as mp
from geomesa_tpu.core.columnar import FeatureBatch as RFB
from geomesa_tpu.core.sft import SimpleFeatureType as RSFT
from geomesa_tpu.parallel.mesh import default_mesh as rdefault_mesh
from geomesa_tpu.plan.datastore import DataStore as RDataStore
from geomesa_tpu.plan.hints import QueryHints as RHints
from geomesa_tpu.plan.query import Query as RQuery
from geomesa_tpu_torch.parallel.mesh import default_mesh
from test_torch_threads import torch_cpu_share  # noqa: F401 (autouse)

D = 4


def _catalog(root: str) -> None:
    sft = RSFT.from_spec(mp.NAME, mp.SPEC)
    RDataStore(root, use_device_cache=True).create_schema(sft).write(
        RFB.from_pydict(sft, mp.rows()))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    base = tmp_path_factory.mktemp("torch_multiprocess")
    root = str(base / "catalog")
    _catalog(root)
    for name in ("ranks", "one", "ref"):
        shutil.copytree(root, str(base / name))
    ranks = mp.spawn("store", 2, "cpu,cpu", str(base), root=str(base / "ranks"))
    one_out, one_arr = {}, {}
    mesh = default_mesh(["cpu"] * D)
    mp.store_answers(str(base / "one"), mesh, "cpu", one_out, one_arr)
    mp.run_engine(mesh, one_out, one_arr)
    ref = RDataStore(str(base / "ref"), use_device_cache=True)
    ref.set_mesh(rdefault_mesh(jax.devices()[:D]))
    return SimpleNamespace(ranks=ranks, one=(one_out, one_arr),
                           ref=ref.get_feature_source(mp.NAME))


def _rank_outs(runs):
    return [(doc, arrays) for doc, arrays, _ in runs.ranks]


def _same_everywhere(runs, key):
    """The array `key` is the same in both ranks and bit-identical to the
    one-process mesh's."""
    want = runs.one[1][key]
    for _, arrays in _rank_outs(runs):
        np.testing.assert_array_equal(arrays[key], want, err_msg=key)
    return want


def test_ranks_run_the_port_alone(runs):
    for doc, _ in _rank_outs(runs):
        assert doc["ok"] and not doc["jax_loaded"]


def test_the_mesh_spans_both_ranks(runs):
    (d0, _), (d1, _) = _rank_outs(runs)
    assert d0["mesh"]["owners"] == d1["mesh"]["owners"] == [0, 0, 1, 1]
    assert d0["mesh"]["local"] == [0, 1] and d1["mesh"]["local"] == [2, 3]
    assert d0["mesh"]["spans_processes"] and not runs.one[0]["mesh"]["spans_processes"]


def test_each_rank_uploads_its_own_shards(runs):
    """Every rank reads the whole superbatch on the host and uploads its
    two shards' rows: half of the one-process tier's rows and bytes."""
    one = runs.one[0]
    for doc, _ in _rank_outs(runs):
        assert doc["shard_rows"] == one["shard_rows"] == 256
        assert doc["upload_rows"] * 2 == one["upload_rows"] == 1024
        assert doc["resident_bytes"] * 2 == one["resident_bytes"]


@pytest.mark.parametrize("key", ["count", "count_day3", "count_day1"])
def test_counts(runs, key):
    cql = {"count": mp.CQL, "count_day3": mp.CQL_DAY3,
           "count_day1": mp.CQL_DAY1}[key]
    want = runs.one[0][key]
    assert want == runs.ref.get_count(cql) > 0
    for doc, _ in _rank_outs(runs):
        assert doc[key] == want


@pytest.mark.parametrize("key", ["density", "density_day1"])
def test_density(runs, key):
    grid = _same_everywhere(runs, key)
    cql = mp.CQL if key == "density" else mp.CQL_DAY1
    ref = runs.ref.get_features(RQuery(mp.NAME, cql, hints=RHints(
        **mp.DENSITY))).grid
    np.testing.assert_array_equal(grid, np.asarray(ref))


@pytest.mark.parametrize("key", ["knn", "knn_day3", "knn_day1"])
def test_knn(runs, key):
    """The whole mesh's program in both ranks: day 1's rows are rank 0's
    alone (rank 1's shards hold no match) and day 3's rank 1's; meters
    and neighbours equal the one-process mesh and the reference's."""
    d = _same_everywhere(runs, f"{key}.d")
    xy = _same_everywhere(runs, f"{key}.xy")
    cql = {"knn": mp.CQL, "knn_day3": mp.CQL_DAY3, "knn_day1": mp.CQL_DAY1}[key]
    qx, qy = mp.queries()
    rd, ridx, rb = runs.ref.knn(cql, qx, qy, k=mp.K)
    col = rb.columns["geom"]
    rxy = np.stack([np.asarray(col.x)[ridx], np.asarray(col.y)[ridx]], -1)
    np.testing.assert_array_equal(d, np.asarray(rd))
    for a, b in zip(xy, rxy):
        assert sorted(map(tuple, a.tolist())) == sorted(map(tuple, b.tolist()))


def test_shard_affinity_is_off_on_a_process_mesh(runs):
    """Day 3's rows live on shard 2 alone and day 1's on shard 0: the
    one-process mesh routes each window to its shard
    (`knn.mesh.local_dispatches`), the process mesh runs the whole mesh in
    both ranks, with the same answers (`test_knn`)."""
    assert runs.one[0]["local_dispatches"] == 2
    for doc, _ in _rank_outs(runs):
        assert doc["local_dispatches"] == 0


def test_no_gather_and_typed_refusals(runs):
    """Counts, densities and kNN gather no column; feature, stats and BIN
    queries need every row's mask in one process: each counts one gather
    and raises RemoteShardError."""
    for doc, _ in _rank_outs(runs):
        assert doc["gathers"] == 0
        assert [doc[f"refused.{w}"] for w in ("features", "stats", "bin")] == [
            "RemoteShardError"] * 3
        assert doc["gathers_refused"] == 3


@pytest.mark.parametrize("route", ["pipelined", "ring"])
def test_served_knn_equals_serial(runs, route):
    """One closed client a rank, eight identical requests: each window is
    bit-identical to the serial call and to the one-process mesh's
    window; the ring serves every window through its mesh program."""
    for j in range(mp.SERVED):
        for part in ("d", "xy"):
            got = _same_everywhere(runs, f"served.{route}.{j}.{part}")
            np.testing.assert_array_equal(got, runs.one[1][f"serial.{j}.{part}"])
    for doc, _ in _rank_outs(runs):
        assert doc[f"served.{route}.windows"] == mp.SERVED
        if route == "ring":
            assert doc["served.ring.ring_windows"] == mp.SERVED


def test_growth_write(runs):
    """Rank 0 writes a fifth day (a growth: its shards are rebuilt from
    the old shards it held, copied device to device, and the rows it did
    not hold uploaded); rank 1 opens the store anew (a full upload of its
    shards). Both answer as the one-process mesh after the same write."""
    (d0, _), (d1, _) = _rank_outs(runs)
    assert d0["grown.count"] == d1["grown.count"] == runs.one[0]["grown.count"]
    assert d0["grown.count"] > d0["count"]
    assert d0["grown.upload_rows"] < d1["grown.upload_rows"] == 1280 // 2
    _same_everywhere(runs, "grown.knn.d")
    _same_everywhere(runs, "grown.knn.xy")


ENGINE = {
    "knn_sparse": ["knn_sparse.8.d", "knn_sparse.8.i"],
    "knn_sparse_overflow": ["knn_fullscan.1.d", "knn_fullscan.1.i"],
    "knn_sharded": ["knn_sharded.d", "knn_sharded.i"],
    "knn_compact": ["knn_compact.d", "knn_compact.i"],
    "knn_indexed": ["knn_indexed.d", "knn_indexed.i", "knn_indexed.u"],
    "density_zsparse": ["zsparse"],
    "stats": ["stats.count", "stats.hist", "stats.z3", "stats.moments"],
    "tube": [f"tube.{i}" for i in range(D)],
    "tube_pruned": [f"tube_pruned.64.{i}" for i in range(D)],
    "polygon_density": ["polygon_density"],
    "pip_layer": ["pip_layer"],
}


@pytest.mark.parametrize("name", sorted(ENGINE))
def test_sharded_engine(runs, name):
    """Each sharded function's merged result equals the one-process mesh's
    bit for bit in both ranks; a sharded result's shards equal the
    one-process mesh's shards where each rank holds them."""
    one = runs.one[1]
    for doc, arrays in _rank_outs(runs):
        for key in ENGINE[name]:
            if key in arrays:
                np.testing.assert_array_equal(arrays[key], one[key], err_msg=key)
            else:  # another rank's shard
                assert int(key.rsplit(".", 1)[-1]) not in doc["mesh"]["local"]
    held = {k for _, a in _rank_outs(runs) for k in a}
    assert set(ENGINE[name]) <= held


def test_one_rank_overflows(runs):
    """Capacity 1: rank 0's shards bear two match tiles each, rank 1's one
    each, so only rank 0 overflows; the flag is merged, both ranks take
    the dense fallback (B2), and the capacity calibration agrees."""
    one = runs.one[0]
    assert one["knn_sparse.1.ov"] and not one["knn_sparse.8.ov"]
    for doc, _ in _rank_outs(runs):
        assert doc["knn_sparse.1.ov"] and not doc["knn_sparse.8.ov"]
        assert doc["shard_match_tiles"] == one["shard_match_tiles"] == 2
        assert doc["tube_pruned.1.ov"] == one["tube_pruned.1.ov"] is True
        assert doc["pip_layer.info"] == one["pip_layer.info"]
        assert doc["knn_compact.ov"] == one["knn_compact.ov"]


def test_knn_ring_refuses_a_process_mesh(runs):
    assert runs.one[0]["knn_ring"] == "answered"
    for doc, _ in _rank_outs(runs):
        assert doc["knn_ring"] == "RemoteShardError"
