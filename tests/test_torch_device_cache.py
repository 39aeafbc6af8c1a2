"""The port's device cache lifecycle (`geomesa_tpu_torch.store.cache`)
against the reference's, after tests/test_device_cache.py.

Each case writes one catalog with the reference (the 300-row gdelt batch
from a seed) and opens it with both packages: refresh after a write,
the residency manifest (save, resume deterministic, resume detecting
drift), invalidate and stats, and the superbatch kept while residency is
unchanged. Counts, stats and the saved manifest must equal the
reference's. The mesh tier's delta growth (TestMeshGrowthDelta) comes
with the multi-GPU tier.
"""

import json

import numpy as np
import pytest

from geomesa_tpu.core.columnar import FeatureBatch as RFB
from geomesa_tpu.core.sft import SimpleFeatureType as RSFT
from geomesa_tpu.plan.datastore import DataStore as RDataStore
from geomesa_tpu.store.cache import DeviceCacheManager as RCache
from geomesa_tpu_torch.core.columnar import FeatureBatch as PFB
from geomesa_tpu_torch.plan.datastore import DataStore as PDataStore
from geomesa_tpu_torch.store.cache import DeviceCacheManager as PCache

CQL = ("BBOX(geom, -120, -60, 120, 60) AND score > 0 AND "
       "dtg DURING 2020-06-01T00:00:00Z/2020-09-01T00:00:00Z")
SPEC = "actor:String,score:Double,dtg:Date,*geom:Point"
CPU = "cpu"


def make_rows(n=300, seed=2):
    rng = np.random.default_rng(seed)
    return {
        "actor": rng.choice(["USA", "FRA", "CHN"], n).tolist(),
        "score": rng.uniform(-10, 10, n),
        "dtg": rng.integers(1_590_000_000_000, 1_600_000_000_000, n),
        "geom": np.stack([rng.uniform(-170, 170, n),
                          rng.uniform(-80, 80, n)], 1)}


@pytest.fixture(scope="module")
def catalog(tmp_path_factory):
    """A reference-written catalog and the port's view of it (read-only
    cases share it)."""
    root = str(tmp_path_factory.mktemp("torch_device_cache"))
    sft = RSFT.from_spec("gdelt", SPEC)
    ref = RDataStore(root, use_device_cache=True)
    rsrc = ref.create_schema(sft)
    rsrc.write(RFB.from_pydict(sft, make_rows()))
    port = PDataStore(root, use_device_cache=True, device=CPU)
    return rsrc, port.get_feature_source("gdelt")


def fresh(tmp_path):
    """A writable catalog: the reference writes, both packages read."""
    sft = RSFT.from_spec("gdelt", SPEC)
    ref = RDataStore(str(tmp_path), use_device_cache=True)
    rsrc = ref.create_schema(sft)
    rsrc.write(RFB.from_pydict(sft, make_rows()))
    port = PDataStore(str(tmp_path), use_device_cache=True, device=CPU)
    return rsrc, port.get_feature_source("gdelt")


def test_cache_refresh_after_write(tmp_path):
    """The port's cached store sees a write made through it, and its
    counts equal the reference's over the same files."""
    rsrc, psrc = fresh(tmp_path)
    before = psrc.get_count(CQL)
    assert before == rsrc.get_count(CQL)
    more = make_rows(150, seed=9)
    psrc.write(PFB.from_pydict(psrc.sft, more))
    after = psrc.get_count(CQL)
    rsrc2 = RDataStore(str(tmp_path), use_device_cache=True
                       ).get_feature_source("gdelt")
    assert after == rsrc2.get_count(CQL) and after >= before
    # refresh on a manager that had the old residency loads the change
    m = PCache(psrc.storage, CPU)
    m.ensure()
    psrc.write(PFB.from_pydict(psrc.sft, make_rows(40, seed=10)))
    changed = m.refresh()
    assert changed and set(m.resident()) == set(psrc.storage.partitions())
    assert m.stats()["rows"] == 300 + 150 + 40


def test_manifest_resume_deterministic(catalog, tmp_path):
    """A fresh manager rebuilds identical residency from the saved
    manifest, and the manifest equals the reference's byte for byte once
    parsed."""
    rsrc, psrc = catalog
    m1 = PCache(psrc.storage, CPU)
    m1.ensure()
    assert m1.resident()
    m1.save_manifest()
    with open(m1.manifest_path) as f:
        port_doc = json.load(f)
    stats1 = m1.stats()
    m2 = PCache(psrc.storage, CPU)
    restored, stale = m2.resume()
    assert restored == m1.resident() and stale == []
    assert m2.stats() == stats1
    r1 = RCache(rsrc.storage)
    r1.ensure()
    r1.save_manifest()
    with open(r1.manifest_path) as f:
        assert json.load(f) == port_doc
    assert stats1 == r1.stats()


def test_manifest_resume_detects_drift(tmp_path):
    rsrc, psrc = fresh(tmp_path)
    m1 = PCache(psrc.storage, CPU)
    m1.ensure()
    m1.save_manifest()
    psrc.write(PFB.from_pydict(psrc.sft, make_rows(50, seed=4)))
    m2 = PCache(psrc.storage, CPU)
    restored, stale = m2.resume()
    assert stale  # at least one partition's files changed
    r2 = RCache(RDataStore(str(tmp_path)).get_feature_source("gdelt").storage)
    assert (restored, stale) == r2.resume()
    m2.ensure()
    assert set(m2.resident()) == set(psrc.storage.partitions())


def test_resume_refuses_another_layout(catalog):
    _, psrc = catalog
    m = PCache(psrc.storage, CPU)
    m.ensure()
    m.save_manifest()
    with open(m.manifest_path) as f:
        doc = json.load(f)
    doc["layout_version"] = 99
    with open(m.manifest_path, "w") as f:
        json.dump(doc, f)
    assert PCache(psrc.storage, CPU).resume() == ([], sorted(doc["partitions"]))


def test_cache_invalidate_and_stats(catalog):
    rsrc, psrc = catalog
    m = PCache(psrc.storage, CPU)
    m.ensure()
    r = RCache(rsrc.storage)
    r.ensure()
    s = m.stats()
    assert s == r.stats()
    assert s["rows"] == 300 and s["padded_rows"] >= s["rows"]
    assert s["uploads"] == len(m.resident())  # one upload a partition
    v = m._version
    p = m.resident()[0]
    assert m.get(p) is not None
    m.invalidate(p)
    assert p not in m.resident() and m.get(p) is None and m._version == v + 1
    m.invalidate()
    assert m.resident() == [] and m.superbatch() is None


def test_superbatch_stable_when_residency_unchanged(tmp_path):
    """Repeat ensure() with unchanged residency serves the SAME superbatch
    (a rebuild would re-upload every resident row); a write makes a new
    one at a newer residency version."""
    _, psrc = fresh(tmp_path)
    m = PCache(psrc.storage, CPU)
    m.ensure()
    sb1 = m.superbatch()
    uploads = m.stats()["uploads"]
    m.ensure()
    assert m.superbatch() is sb1 and m.superbatch_peek() is sb1
    assert m.stats()["uploads"] == uploads
    psrc.write(PFB.from_pydict(psrc.sft, make_rows()))
    m.ensure()
    sb2 = m.superbatch()
    assert sb2 is not sb1 and sb2.version > sb1.version
