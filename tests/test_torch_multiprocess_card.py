"""The multi-process runtime on the card: two ranks x two shards of one
mesh on cuda:0 over gloo (the collectives through pinned host memory).

The ranks (`tests/torch_mp_ranks.py`) run the store's answers, the
pipelined route, the ring's per-rank graphs and the engine's sharded
functions; a one-process mesh of four shards on the card over a copy of
the same files is the oracle, bit for bit. Skips without a card. This
file imports no JAX: the catalog is written by the port."""

import shutil

import numpy as np
import pytest
import torch

import torch_mp_ranks as mp
from geomesa_tpu_torch import DataStore, FeatureBatch, SimpleFeatureType
from geomesa_tpu_torch.parallel.mesh import default_mesh

D = 4


@pytest.mark.cuda
def test_two_ranks_share_the_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the ranks' kernels and graphs run there")
    root = str(tmp_path / "catalog")
    sft = SimpleFeatureType.from_spec(mp.NAME, mp.SPEC)
    DataStore(root, device="cuda").create_schema(sft).write(
        FeatureBatch.from_pydict(sft, mp.rows()))
    for name in ("ranks", "one"):
        shutil.copytree(root, str(tmp_path / name))
    ranks = mp.spawn("store", 2, "cuda:0,cuda:0", str(tmp_path),
                     root=str(tmp_path / "ranks"))
    one_out, one_arr = {}, {}
    mesh = default_mesh(["cuda:0"] * D)
    mp.store_answers(str(tmp_path / "one"), mesh, "cuda:0", one_out, one_arr)
    mp.run_engine(mesh, one_out, one_arr)
    for doc, arrays, _ in ranks:
        assert doc["ok"] and doc["served.ring.ring_windows"] == mp.SERVED
        compared = 0
        for key, want in one_arr.items():
            if key in arrays:
                np.testing.assert_array_equal(arrays[key], want, err_msg=key)
                compared += 1
        assert compared > 40
        for key in ("count", "count_day3", "count_day1", "grown.count",
                    "knn_sparse.1.ov", "tube_pruned.1.ov"):
            assert doc[key] == one_out[key], key
        assert doc["local_dispatches"] == 0 and doc["gathers"] == 0
