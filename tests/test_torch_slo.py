"""The port's SLO engine (`geomesa_tpu_torch.telemetry.slo`) and its wiring
into the QueryService, against the reference's.

Spec parsing (TOML, the TOML subset, JSON and the typed refusals) and the
engine's burn rates, `report()`, `degrade_boost` and `exactness_spent`
run on the same inputs in both packages, on a fake clock. The closed
loop runs through both packages' services over one catalog (600 rows
written by the reference, the port reading it on the CPU), each with an
injected engine on a fake clock: a latency objective no request can meet
burns until the degradation ladder engages with an empty queue, and an
exactness budget spent by sketch-served counts routes the next tolerant
count exact. Both services must take the same steps.
"""

import json
from types import SimpleNamespace

import numpy as np
import pytest

import geomesa_tpu.serve as rserve
import geomesa_tpu.telemetry.slo as rslo
import geomesa_tpu_torch.serve as pserve
import geomesa_tpu_torch.telemetry.slo as pslo
from geomesa_tpu.core.columnar import FeatureBatch as RFB
from geomesa_tpu.core.sft import SimpleFeatureType as RSFT
from geomesa_tpu.plan.datastore import DataStore as RDataStore
from geomesa_tpu.serve.scheduler import QueryRejected as RQueryRejected
from geomesa_tpu_torch.plan.datastore import DataStore as PDataStore
from geomesa_tpu_torch.serve.scheduler import QueryRejected as PQueryRejected
from geomesa_tpu_torch.utils.metrics import metrics as pmetrics

PKG = {
    "ref": SimpleNamespace(slo=rslo, serve=rserve, Rejected=RQueryRejected),
    "port": SimpleNamespace(slo=pslo, serve=pserve, Rejected=PQueryRejected),
}
PACKAGES = list(PKG)

TOML = """
# serve objectives
[slo]
fast_window_s = 2.0
slow_window_s = 8.0   # scaled for tests
burn_threshold = 2.0

[objective.knn_p99]
kind = "latency"
threshold_ms = 25.0
goal = 0.9
query_kind = "knn"
degrade = true

[objective.availability]
kind = "availability"
goal = 0.999

[objective.exact]
kind = "exactness"
goal = 0.95
min_count = 4
"""

SPEC_JSON = {
    "slo": {"fast_window_s": 1.0, "slow_window_s": 4.0,
            "budget_window_s": 3.0},
    "objective": {
        "tput": {"kind": "throughput", "min_per_s": 10.0,
                 "pts_per_query": 256.0},
        "lat": {"kind": "latency", "threshold_ms": 5.0, "goal": 0.8,
                "degrade": True, "min_count": 3},
    },
}


def spec_doc(spec):
    return {"objectives": {n: vars(o) for n, o in spec.objectives.items()},
            "windows": (spec.fast_window_s, spec.slow_window_s,
                        spec.budget_window_s, spec.burn_threshold)}


def test_spec_parsing_matches_reference(tmp_path):
    """A .toml spec (tomllib), the same text through the TOML subset, and
    a .json spec parse to equal specs in both packages."""
    (tmp_path / "s.toml").write_text(TOML)
    (tmp_path / "s.json").write_text(json.dumps(SPEC_JSON))
    got = {}
    for pkg in PACKAGES:
        slo = PKG[pkg].slo
        got[pkg] = (spec_doc(slo.SloSpec.load(str(tmp_path / "s.toml"))),
                    slo.parse_toml_subset(TOML),
                    spec_doc(slo.SloSpec.from_dict(slo.parse_toml_subset(TOML))),
                    spec_doc(slo.SloSpec.load(str(tmp_path / "s.json"))))
    assert got["port"] == got["ref"]
    toml_spec, subset, from_subset, js = got["port"]
    assert toml_spec == from_subset
    assert toml_spec["windows"] == (2.0, 8.0, 8.0, 2.0)
    assert toml_spec["objectives"]["knn_p99"]["degrade"] is True
    assert js["objectives"]["tput"]["min_per_s"] == 10.0


BAD_SPECS = [
    {"slo": {}},
    {"objective": {"x": {"kind": "nope"}}},
    {"objective": {"x": {"kind": "latency"}}},
    {"objective": {"x": {"kind": "throughput"}}},
    {"objective": {"x": {"kind": "availability", "goal": 1.0}}},
    {"objective": {"x": {"kind": "availability", "typo_ms": 3}}},
    {"objective": {"x": 3}},
    {"slo": {"fast_window_s": 10.0, "slow_window_s": 5.0},
     "objective": {"x": {"kind": "availability"}}},
    {"slo": {"bogus": 1}, "objective": {"x": {"kind": "availability"}}},
]
BAD_TOML = ["just words\n", "x = [1, 2]\n", "[a\n", "[a..b]\n", 'x = "open\n',
            "x = 1\n[x]\n"]


@pytest.mark.parametrize("pkg", PACKAGES)
def test_spec_refusals(pkg):
    """Each malformed spec raises ValueError, with the reference's message
    in both packages."""
    slo = PKG[pkg].slo
    msgs = []
    for doc in BAD_SPECS:
        with pytest.raises(ValueError) as ei:
            slo.SloSpec.from_dict(doc)
        msgs.append(str(ei.value))
    for text in BAD_TOML:
        with pytest.raises(ValueError) as ei:
            slo.parse_toml_subset(text)
        msgs.append(str(ei.value))
    other = PKG["ref" if pkg == "port" else "port"].slo
    for doc, msg in zip(BAD_SPECS, msgs):
        with pytest.raises(ValueError) as ei:
            other.SloSpec.from_dict(doc)
        assert str(ei.value) == msg
    with pytest.raises(ValueError, match="at least one objective"):
        slo.SloEngine(slo.SloSpec())


def drive(pkg, steps):
    """Run one observation script on a fake-clock engine of `pkg`; returns
    every reading the script asks for."""
    slo = PKG[pkg].slo
    spec = slo.SloSpec.from_dict({
        "slo": {"fast_window_s": 2.0, "slow_window_s": 8.0,
                "burn_threshold": 2.0},
        "objective": {
            "lat": {"kind": "latency", "threshold_ms": 10.0, "goal": 0.9,
                    "degrade": True, "min_count": 4, "query_kind": "knn"},
            "avail": {"kind": "availability", "goal": 0.99, "min_count": 4},
            "exact": {"kind": "exactness", "goal": 0.8, "min_count": 4},
            "tput": {"kind": "throughput", "min_per_s": 10.0,
                     "pts_per_query": 4.0, "degrade": True},
        }})
    now = [1000.0]
    eng = slo.SloEngine(spec, clock=lambda: now[0], max_observations=64)
    eng.boost_ttl_s = 0.0
    out = []
    for op, *args in steps:
        if op == "obs":
            eng.observe(*args)
        elif op == "tick":
            now[0] += args[0]
        else:
            out.append((
                {n: eng.burn_rates(o) for n, o in spec.objectives.items()},
                {n: eng.budget_remaining(o)
                 for n, o in spec.objectives.items()},
                eng.breaching(), eng.degrade_boost(), eng.exactness_spent(),
                eng.report(), slo.render_slo(eng.report())))
    return out


def script(seed=11):
    rng = np.random.default_rng(seed)
    steps = [("read",)]
    kinds = ["knn", "count", "execute"]
    statuses = ["ok", "ok", "ok", "error", "timeout", "rejected", "cancelled"]
    for phase in range(6):
        for _ in range(int(rng.integers(5, 40))):
            steps.append(("obs", kinds[int(rng.integers(0, 3))],
                          statuses[int(rng.integers(0, 7))] if phase % 2
                          else "ok",
                          float(rng.choice([0.001, 0.5])),
                          bool(rng.random() < 0.4)))
            steps.append(("tick", float(rng.uniform(0.0, 0.2))))
        steps.append(("read",))
        steps.append(("tick", float(rng.choice([0.5, 3.0, 9.0]))))
        steps.append(("read",))
    return steps


def test_engine_matches_reference_on_a_fake_clock():
    """Burn rates, budgets, the breaching list, degrade_boost,
    exactness_spent, report() and its rendering, step for step, over a
    seeded script that breaches, ages out, drops observations (a 64-deep
    deque) and recovers."""
    steps = script()
    got = {pkg: drive(pkg, steps) for pkg in PACKAGES}
    assert got["port"] == got["ref"]
    boosts = {r[3] for r in got["port"]}
    assert boosts >= {0, 2} or boosts >= {0, 1}
    assert any(r[4] for r in got["port"]) and not all(r[4] for r in got["port"])
    assert any(r[5]["observations"]["dropped"] for r in got["port"])


# -- the closed loop through both services -----------------------------------

CQL = "BBOX(geom, -170, -80, 170, 80)"


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("torch_slo"))
    rng = np.random.default_rng(3)
    n = 600
    rows = {
        "name": rng.choice(["a", "b", "c"], n).tolist(),
        "score": rng.uniform(-10, 10, n),
        "dtg": rng.integers(1_590_000_000_000, 1_600_000_000_000, n),
        "geom": np.stack([rng.uniform(-170, 170, n),
                          rng.uniform(-80, 80, n)], 1),
    }
    sft = RSFT.from_spec("served", "name:String,score:Double,dtg:Date,*geom:Point")
    ref = RDataStore(root, use_device_cache=True)
    ref.create_schema(sft).write(RFB.from_pydict(sft, rows))
    port = PDataStore(root, use_device_cache=True, device="cpu")
    return {"ref": ref, "port": port, "n": n}


def closed_loop(pkg, store):
    """The steps of one service with an injected fake-clock engine:
    healthy -> burning (every request misses a 1 ns objective) -> the
    ladder engages on burn alone, batch work sheds, an opted-in request
    degrades -> the breach ages out -> sketch-served counts spend the
    exactness budget -> the next tolerant count is exact."""
    p = PKG[pkg]
    slo = p.slo
    spec = slo.SloSpec.from_dict({
        "slo": {"fast_window_s": 2.0, "slow_window_s": 8.0,
                "burn_threshold": 2.0},
        "objective": {
            "knn_lat": {"kind": "latency", "threshold_ms": 1e-6,
                        "goal": 0.9, "query_kind": "knn", "degrade": True,
                        "min_count": 4},
            "avail": {"kind": "availability", "goal": 0.99, "min_count": 4},
            "exact": {"kind": "exactness", "goal": 0.5, "min_count": 4,
                      "query_kind": "count"},
        }})
    now = [5000.0]
    eng = slo.SloEngine(spec, clock=lambda: now[0])
    eng.boost_ttl_s = 0.0
    svc = p.serve.QueryService(store, p.serve.ServeConfig(
        pipeline=False, ring=False, degrade=True, slo=eng, result_cache=0,
        max_wait_ms=0.0), autostart=False)
    steps = []
    try:
        svc.start()
        steps.append(("start", svc.degrade_level(), eng.report()["breaching"]))
        for i in range(6):
            svc.knn("served", CQL, [float(i)], [10.0], k=5).result(timeout=120)
        now[0] += 0.1
        rep = svc.stats()["slo"]
        steps.append(("burn", rep["breaching"], rep["degrade_boost"],
                      len(svc.queue), svc.degrade_level()))
        with pytest.raises(p.Rejected, match="shed"):
            svc.count("served", CQL, priority="batch")
        before = svc.stats().get("degraded", 0)
        svc.knn("served", CQL, [0.0], [0.0], k=5,
                allow_degraded=True).result(timeout=120)
        steps.append(("degraded", svc.stats().get("degraded", 0) - before))
        now[0] += 10.0
        steps.append(("aged", svc.degrade_level(), eng.report()["breaching"]))
        from_tier = []
        for _ in range(6):
            from_tier.append(svc.stats()["approx"]["allowed_now"])
            got = svc.submit(svc._request(
                "count", tolerant_query(pkg))).result(timeout=120)
            from_tier.append(bool(getattr(got, "approx", False)))
        rep = svc.stats()["slo"]
        steps.append(("exact", from_tier,
                      rep["objectives"]["exact"]["state"],
                      svc.stats()["approx"]["allowed_now"],
                      svc.stats()["approx"]["budget_exact"],
                      svc.stats().get("approx_disabled", 0)))
        stats = svc.stats()
        steps.append(("counters", {k: stats.get(k, 0) for k in (
            "submitted", "completed", "rejected", "shed", "failed",
            "approx_served")}))
    finally:
        svc.close(drain=True)
    return steps


def tolerant_query(pkg):
    if pkg == "ref":
        from geomesa_tpu.plan.hints import QueryHints
        from geomesa_tpu.plan.query import Query
    else:
        from geomesa_tpu_torch.plan.hints import QueryHints
        from geomesa_tpu_torch.plan.query import Query
    return Query("served", CQL, hints=QueryHints(tolerance=0.5))


def test_closed_loop_matches_reference(stores):
    """Both services take the same steps; the port's also exports the
    slo gauges."""
    got = {pkg: closed_loop(pkg, stores[pkg]) for pkg in PACKAGES}
    assert got["port"] == got["ref"]
    steps = dict((s[0], s[1:]) for s in got["port"])
    assert steps["start"] == (0, [])
    breaching, boost, queued, level = steps["burn"]
    assert "knn_lat" in breaching and boost >= 1 and queued == 0
    assert level >= 1
    assert steps["degraded"] == (1,)
    assert steps["aged"] == (0, [])
    tiers, state, allowed, budget_exact, disabled = steps["exact"]
    # sketch-served while the budget lasts, exact once it is spent: the
    # governor acted (budget_exact), the tier is not disabled
    assert tiers[:2] == [True, True] and tiers[-2:] == [False, False]
    assert state == "violated" and allowed is False
    assert budget_exact >= 1 and disabled == 0


def test_service_builds_engine_from_every_spec_form(stores, tmp_path):
    """ServeConfig.slo takes a path (.toml and .json), a dict, an SloSpec
    or a ready SloEngine, as the reference's; export_gauges writes the
    slo.* gauges."""
    (tmp_path / "s.toml").write_text(TOML)
    (tmp_path / "s.json").write_text(json.dumps(SPEC_JSON))
    spec = pslo.SloSpec.from_dict(SPEC_JSON)
    eng = pslo.SloEngine(spec)
    for form in (str(tmp_path / "s.toml"), str(tmp_path / "s.json"),
                 SPEC_JSON, spec, eng):
        svc = pserve.QueryService(stores["port"], pserve.ServeConfig(
            pipeline=False, ring=False, slo=form), autostart=False)
        try:
            assert isinstance(svc.slo, pslo.SloEngine)
            if form is eng:
                assert svc.slo is eng
            names = set(svc.stats()["slo"]["objectives"])
            svc.export_gauges()
        finally:
            svc.close()
        prom = pmetrics.to_prometheus()
        for name in names:
            assert f'slo_budget_remaining{{objective="{name}"}}' in prom
            assert (f'slo_burn_rate{{objective="{name}",window="fast"}}'
                    in prom)
