"""The port's multi-process runtime (`parallel/distributed.py`,
`parallel/launch.py`) on the CPU.

Ranks run `tests/torch_mp_ranks.py` over gloo with a `file://` init in
the test's directory (no TCP port to race other test workers): two ranks
of two `cpu` shards run the runtime checks and `smoke_step`, four ranks
of one shard run `smoke_step`. The smoke grid must equal the reference's
`density_sharded` on 4 of the 8 CPU devices tests/conftest.py forces,
over the same seeded inputs; only rank 0 may write the store metadata,
the device-cache manifest, the sketch sidecar and the warm-up manifest;
each rank's flight dump takes its own `.p<rank>` suffix; a rank whose
fingerprint differs makes `assert_uniform_runtime` raise in every rank.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_mp_ranks as mp
from geomesa_tpu.engine.density import density_sharded as rdensity_sharded
from geomesa_tpu.parallel import distributed as rdist
from geomesa_tpu.parallel.mesh import default_mesh as rdefault_mesh
from geomesa_tpu_torch import DataStore, FeatureBatch, SimpleFeatureType
from geomesa_tpu_torch.parallel import distributed as dd
from geomesa_tpu_torch.parallel import launch
from geomesa_tpu_torch.parallel.mesh import default_mesh


@pytest.fixture(scope="module")
def two(tmp_path_factory):
    base = tmp_path_factory.mktemp("torch_distributed_two")
    root = str(base / "catalog")
    sft = SimpleFeatureType.from_spec("t", "score:Double,dtg:Date,*geom:Point")
    rng = np.random.default_rng(3)
    n = 512
    DataStore(root, device="cpu").create_schema(sft).write(
        FeatureBatch.from_pydict(sft, {
            "score": rng.uniform(0, 10, n),
            "dtg": 1_591_000_000_000 + rng.integers(0, 3 * 86_400_000, n),
            "geom": np.stack([rng.uniform(-50, 50, n),
                              rng.uniform(-40, 40, n)], 1)}))
    return mp.spawn("runtime", 2, "cpu,cpu", str(base), root=root), str(base)


@pytest.fixture(scope="module")
def four(tmp_path_factory):
    base = tmp_path_factory.mktemp("torch_distributed_four")
    return mp.spawn("smoke", 4, "cpu", str(base))


def smoke_oracle(d: int):
    """The reference's `density_sharded` on `d` CPU devices over the
    smoke step's inputs, and the NumPy count and sum."""
    n = d * 512
    rng = np.random.default_rng(42)
    x = rng.uniform(-60, 60, n).astype(np.float32)
    y = rng.uniform(-45, 45, n).astype(np.float32)
    score = rng.uniform(-10, 10, n).astype(np.float32)
    m = (np.abs(x) < 50) & (score > 0)
    grid = rdensity_sharded(
        rdefault_mesh(jax.devices()[:d]), jnp.asarray(x), jnp.asarray(y),
        jnp.ones(n, jnp.float32), jnp.asarray(m), (-60.0, -45.0, 60.0, 45.0),
        16, 16)
    return np.asarray(grid), int(m.sum()), float(score[m].astype(np.float64).sum())


@pytest.mark.parametrize("layout", ["2x2", "4x1"])
def test_smoke_step_every_rank(two, four, layout):
    ranks = two[0] if layout == "2x2" else four
    grid, count, total = smoke_oracle(4)
    for r, (doc, arrays, _) in enumerate(ranks):
        s = doc["smoke"]
        assert doc["ok"] and s["ok"] and not doc["jax_loaded"]
        assert s["process"] == r and s["processes"] == len(ranks)
        assert s["shards"] == 4 and s["count"] == count
        assert abs(s["sum"] - total) < 1e-6 * abs(total)
        np.testing.assert_array_equal(arrays["smoke.grid"], grid)


def test_shards_in_rank_order(two, four):
    assert [d["smoke"]["local"] for d, _, _ in two[0]] == [[0, 1], [2, 3]]
    assert [d["smoke"]["local"] for d, _, _ in four] == [[0], [1], [2], [3]]


def test_coordinator_and_suffix_in_the_ranks(two):
    docs = [d for d, _, _ in two[0]]
    assert [d["is_coordinator"] for d in docs] == [True, False]
    assert [d["process_suffix"] for d in docs] == [".p0", ".p1"]


def test_coordinator_and_suffix_on_one_process():
    assert dd.is_coordinator() and dd.process_suffix() == ""
    assert dd.backend() is None and dd.process_count() == 1
    dd.assert_uniform_runtime()  # a no-op without a group


def test_fingerprint_is_shared(two):
    fp = dd.runtime_fingerprint()
    assert 0 <= fp < 2 ** 31 and fp == dd.runtime_fingerprint()
    assert [d["fingerprint"] for d, _, _ in two[0]] == [fp, fp]


def test_divergent_fingerprint_raises_in_every_rank(two):
    for doc, _, _ in two[0]:
        assert doc["divergent"].startswith(
            "divergent runtime configuration across processes")


@pytest.mark.parametrize("what", ["metadata", "cache", "sidecar", "warmup"])
def test_only_rank_0_writes_shared_files(two, what):
    """Rank 1 saves first and nothing changes; then rank 0 saves."""
    doc = two[0][0][0]
    before, after1, after0 = (doc[k][what] for k in (
        "gates.before", "gates.after_rank1", "gates.after_rank0"))
    assert after1 == before
    assert after0 is not None and after0 != before


def test_flight_dumps_per_rank(two):
    ranks, base = two
    for r, (doc, _, _) in enumerate(ranks):
        assert doc["dump"] == os.path.join(base, f"flight.p{r}.json")
        assert os.path.exists(doc["dump"])
    assert not os.path.exists(os.path.join(base, "flight.json"))


def test_flight_dump_unsuffixed_on_one_process(tmp_path):
    from geomesa_tpu_torch.telemetry.recorder import FlightRecorder

    path = str(tmp_path / "flight.json")
    assert FlightRecorder().dump(path) == path and os.path.exists(path)


def test_global_mesh_on_one_process():
    m = dd.global_mesh(["cpu"] * 2)
    assert m == default_mesh(["cpu"] * 2) and not m.spans_processes
    assert m.local == (0, 1) and m.owners == (0, 0)


def test_process_partitions_equals_the_reference():
    names = [f"2020/06/{d:02d}" for d in np.random.default_rng(9).permutation(30) + 1]
    for n in (1, 2, 3, 4):
        got = [dd.process_partitions(names, i, n) for i in range(n)]
        assert got == [rdist.process_partitions(names, i, n) for i in range(n)]
        assert sorted(sum(got, [])) == sorted(names)
    assert dd.process_partitions(names) == sorted(names)


def test_initialize_needs_its_three_values(monkeypatch):
    for k in ("GEOMESA_TPU_COORDINATOR", "GEOMESA_TPU_NUM_PROCESSES",
              "GEOMESA_TPU_PROCESS_ID"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(ValueError, match="coordinator"):
        dd.initialize()


def test_launcher_runs_two_workers(tmp_path):
    """`python -m geomesa_tpu_torch.parallel.launch --num-processes 2
    --devices cpu,cpu`: both workers pass the smoke step."""
    init = "file://" + str(tmp_path / "init")
    assert launch.main(["--num-processes", "2", "--devices", "cpu,cpu",
                        "--coordinator", init]) == 0


def test_a_failed_worker_fails_the_launch(tmp_path, capsys):
    init = "file://" + str(tmp_path / "init")
    assert launch.launch_local(1, devices=["no-such-device"],
                               init_method=init) == 1
    assert "FAILED" in capsys.readouterr().out


def test_default_mesh_gives_each_rank_its_own_cards(two):
    """With no device list, rank r of two on one host takes only its own
    cards (and leads on its first), shares the one card there is, and
    NCCL is chosen only when each rank has a card of its own."""
    seen = [d["default_mesh"] for d, _, _ in two[0]]
    for doc in seen:
        assert doc["1"]["devices"] == ["cuda:0", "cuda:0"]
        assert doc["2"]["devices"] == ["cuda:0", "cuda:1"]
        assert doc["4"]["devices"] == ["cuda:0", "cuda:1", "cuda:2", "cuda:3"]
        assert doc["2"]["owners"] == [0, 1] and doc["4"]["owners"] == [0, 0, 1, 1]
        assert [doc[c]["backend"] for c in ("1", "2", "4")] == ["gloo", "nccl", "nccl"]
    assert [doc["2"]["local"] for doc in seen] == [[0], [1]]
    assert [doc["2"]["lead"] for doc in seen] == ["cuda:0", "cuda:1"]
    assert [doc["4"]["lead"] for doc in seen] == ["cuda:0", "cuda:2"]


@pytest.mark.parametrize("env,pid,n,cards,want", [
    ({}, 1, 2, 2, ((1, 2), [1], "nccl")),
    ({}, 1, 2, 1, ((1, 2), [0], "gloo")),
    ({}, 3, 4, 2, ((3, 4), [1], "gloo")),
    ({}, 0, 2, 0, ((0, 2), [], "gloo")),
    # two hosts of two ranks: the host's ranks decide, not the world size
    ({"LOCAL_WORLD_SIZE": "2"}, 3, 4, 2, ((1, 2), [1], "nccl")),
    ({"LOCAL_WORLD_SIZE": "2", "LOCAL_RANK": "0"}, 2, 4, 4, ((0, 2), [0, 1], "nccl")),
])
def test_host_layout_cards_and_backend(monkeypatch, env, pid, n, cards, want):
    import torch

    for k in ("LOCAL_WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: cards > 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    layout = dd.host_layout(pid, n)
    assert (layout, dd.rank_cards(*layout, cards),
            dd.default_backend(pid, n)) == want


def test_rank_devices_without_a_group(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert dd.rank_devices() == [torch.device("cuda", 0), torch.device("cuda", 1)]


def test_topk_pair_bits_cross_in_one_buffer():
    """`merge_topk` sends distances and indices in one int64 buffer on a
    process mesh: every bit comes back, -0.0, inf and NaN included."""
    import torch

    from geomesa_tpu_torch.parallel.mesh import _bits64, _from_bits64

    d = torch.tensor([[-0.0, 0.0, float("inf"), float("nan"), 1e-38, -3.5]])
    for t in (d, d.double(), torch.tensor([[-1, 0, 2 ** 31 - 1]], dtype=torch.int32),
              torch.tensor([[-1, 2 ** 40, 7]])):
        both = torch.cat([_bits64(t), _bits64(t)], -1)
        back = _from_bits64(both[..., :t.shape[-1]], t.dtype)
        assert back.dtype == t.dtype
        assert torch.equal(back.view(torch.uint8), t.view(torch.uint8))
