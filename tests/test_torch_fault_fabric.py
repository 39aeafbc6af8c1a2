"""The port's fault fabric (`geomesa_tpu_torch.faults`) against the
reference's, on the same plans, call sequences and seeds.

Plans saved by one package load in the other; the same plan and call
sequence give the same fire log (schedules, seeded probabilities, glob
sites) and the nested-install refusal; a seeded backoff sequence, the
breaker's state machine under a fake clock and the error taxonomy
agree. On served kNN (the serial, pipelined and ring routes) the
ServeEvent `retries`/`fault_injected`/`breaker_state` equal the
reference's window for window, sum to the harness's fire log, and every
faulted answer equals the clean one. An always-failing transfer opens
the "device" breaker and the wire answers `unavailable` as the
reference's does; a half-open probe closes it. A manifest commit that
fails rolls a write, a delete and a compact back; a fault while a ring
program arms leaves no capture behind. Each package serves its own copy
of one seeded catalog, so both see the same files.
"""

import json
import os
import time
from random import Random

import numpy as np
import pytest
import torch

from geomesa_tpu import faults as rf
from geomesa_tpu.core.columnar import FeatureBatch as RFB
from geomesa_tpu.core.sft import SimpleFeatureType as RSFT
from geomesa_tpu.plan.audit import ServeEvent as REvent
from geomesa_tpu.plan.datastore import DataStore as RDataStore
from geomesa_tpu.serve import QueryService as RService
from geomesa_tpu.serve import ServeConfig as RConfig
from geomesa_tpu.serve.protocol import serve_lines as r_serve_lines
from geomesa_tpu_torch import faults as pf
from geomesa_tpu_torch.core.columnar import FeatureBatch as PFB
from geomesa_tpu_torch.core.sft import SimpleFeatureType as PSFT
from geomesa_tpu_torch.plan.audit import ServeEvent as PEvent
from geomesa_tpu_torch.plan.datastore import DataStore as PDataStore
from geomesa_tpu_torch.serve import QueryService as PService
from geomesa_tpu_torch.serve import ServeConfig as PConfig
from geomesa_tpu_torch.serve.protocol import serve_lines as p_serve_lines

SPEC = "name:String,score:Double,dtg:Date,*geom:Point"
CQL = "BBOX(geom, -170, -80, 170, 80) AND score > -5"
T0 = 1_590_000_000_000
DAY = 86400_000

PKG = {
    "ref": dict(faults=rf, fb=RFB, sft=RSFT, event=REvent, service=RService,
                config=RConfig, serve_lines=r_serve_lines,
                store=lambda root: RDataStore(root, use_device_cache=True)),
    "port": dict(faults=pf, fb=PFB, sft=PSFT, event=PEvent, service=PService,
                 config=PConfig, serve_lines=p_serve_lines,
                 store=lambda root: PDataStore(root, use_device_cache=True,
                                               device="cpu")),
}
ROUTES = {"serial": dict(pipeline=False, ring=False),
          "pipelined": dict(ring=False), "ring": dict()}


@pytest.fixture(autouse=True)
def _pristine_fabric():
    """No harness installed and closed breakers around every test (the
    fabric is process-global in both packages)."""
    for f in (rf, pf):
        f.uninstall()
        f.BREAKERS.reset()
    yield
    for f in (rf, pf):
        f.uninstall()
        f.BREAKERS.reset()
    rf.BREAKERS.restore_config("device", None)
    pf.BREAKERS.restore_config("device")


def rows(n, seed):
    rng = np.random.default_rng(seed)
    return {"name": rng.choice(["a", "b", "c"], n).tolist(),
            "score": rng.uniform(-10, 10, n),
            "dtg": rng.integers(T0, T0 + 2 * DAY, n),
            "geom": np.stack([rng.uniform(-170, 170, n),
                              rng.uniform(-80, 80, n)], 1)}


@pytest.fixture(scope="module")
def catalogs(tmp_path_factory):
    """One seeded catalog per package, warm (resident) before any plan."""
    out = {}
    for name, pkg in PKG.items():
        ds = pkg["store"](str(tmp_path_factory.mktemp(f"faults_{name}")))
        sft = pkg["sft"].from_spec("faulty", SPEC)
        src = ds.create_schema(sft)
        src.write(pkg["fb"].from_pydict(sft, rows(3000, 9)))
        src.knn(CQL, [0.0], [0.0], k=5)
        out[name] = ds
    return out


# -- plans and the harness ----------------------------------------------------

def make_plan(f, seed=11):
    return f.FaultPlan(
        rules=[f.FaultRule(site="fs.*", error="io", every=3, max_fires=2,
                           latency_ms=1.0),
               f.FaultRule(site="device.transfer", error="oom",
                           probability=0.25),
               f.FaultRule(site="kafka.poll", error="unavailable",
                           nth_call=2)],
        seed=seed, expect_breakers=["storage"])


@pytest.mark.parametrize("writer,reader", [("ref", "port"), ("port", "ref")])
def test_plan_saved_by_one_package_loads_in_the_other(tmp_path, writer,
                                                      reader):
    path = str(tmp_path / "plan.json")
    make_plan(PKG[writer]["faults"]).save(path)
    loaded = PKG[reader]["faults"].FaultPlan.load(path)
    assert loaded.to_json() == make_plan(PKG[writer]["faults"]).to_json()
    assert loaded == make_plan(PKG[reader]["faults"])


SCHEDULES = {
    "every_capped": ([dict(site="t.sched", error="io", every=3,
                           max_fires=2)], ["t.sched"]),
    "nth_call": ([dict(site="t.nth", error="unavailable", nth_call=4)],
                 ["t.nth"]),
    "probability": ([dict(site="t.prob", error="io", probability=0.3)],
                    ["t.prob"]),
    "glob_and_rule_order": ([dict(site="tglob.*", error="crash", nth_call=2),
                             dict(site="tglob.read", error="io", every=2),
                             dict(site="tglob.read", error="oom",
                                  probability=0.5)],
                            ["tglob.read", "tglob.write", "tglob.other"]),
}


def replay(f, rules, sites, seed=123, calls=60):
    """(call, site, exception class) per fire and the harness's fire log
    for `calls` fires round-robin over `sites`."""
    plan = f.FaultPlan(rules=[f.FaultRule(**r) for r in rules], seed=seed)
    bound = [f.site(s) for s in sites]
    seen = []
    with f.active(plan) as h:
        for i in range(calls):
            s = bound[i % len(bound)]
            try:
                s.fire()
            except Exception as e:  # noqa: BLE001 — every injected kind
                assert f.is_typed(e) and isinstance(e, f.FaultInjected)
                seen.append((i, s.name, type(e).__name__))
        return seen, h.fire_log()


@pytest.mark.parametrize("case", sorted(SCHEDULES))
def test_fire_log_replays_across_packages(case):
    rules, sites = SCHEDULES[case]
    ref = replay(rf, rules, sites)
    port = replay(pf, rules, sites)
    assert port == ref
    assert replay(pf, rules, sites) == port  # and replays itself
    assert port[1], "the schedule never fired"


def test_nested_install_refused_and_inactive_sites_are_free():
    for f in (rf, pf):
        plan = f.FaultPlan(rules=[f.FaultRule(site="tn.x", error="io",
                                              every=1)])
        s = f.site("tn.x")
        s.fire()  # no harness: a no-op
        with f.active(plan):
            with pytest.raises(RuntimeError):
                f.install(plan)
        s.fire()
        assert f.current() is None


# -- retry and breaker ---------------------------------------------------------

def test_backoff_and_retry_sleeps_match_for_a_seeded_random():
    out = {}
    for name, f in (("ref", rf), ("port", pf)):
        policy = f.RetryPolicy(max_attempts=5, base_ms=10.0, cap_ms=60.0)
        rng = Random(5)
        seq = [policy.backoff_ms(a, rng) for a in range(8)]
        calls, slept = [], []

        def flaky():
            calls.append(1)
            if len(calls) < 4:
                raise ConnectionError("down")
            return "ok"

        tok = f.RECOVERY.token()
        got = f.retry_call(flaky, policy=policy, label="t", rng=Random(7),
                           sleep=slept.append)
        notes = f.RECOVERY.since(tok)
        with pytest.raises(ValueError):  # permanent: one call, no sleep
            f.retry_call(lambda: (_ for _ in ()).throw(ValueError("bad")),
                         policy=policy, label="t", sleep=slept.append)
        out[name] = (seq, got, len(calls), slept, notes)
    assert out["port"] == out["ref"]
    assert out["port"][3] and all(0 <= s <= 0.06 for s in out["port"][3])


def drive_breaker(f):
    """The closed -> open -> half-open -> closed cycle, a failed probe, a
    vanished probe, under a fake clock: the states and refusals seen."""
    now = [0.0]
    b = f.CircuitBreaker("t", failure_threshold=3, reset_timeout_s=10.0,
                         clock=lambda: now[0])
    log = []

    def allow():
        try:
            b.allow()
            log.append(("allow", b.state))
        except f.BreakerOpen as e:
            log.append(("open", round(e.retry_after_s, 6), e.reason))

    for _ in range(3):
        allow()
        b.record_failure()
    log.append(b.state)
    now[0] = 4.0
    allow()
    now[0] = 10.5
    allow()          # half-open probe
    allow()          # the probe budget is spent
    b.record_failure()  # the probe failed: open again
    log.append(b.state)
    now[0] = 21.0
    allow()          # a probe that never reports back ...
    now[0] = 32.0
    allow()          # ... goes stale after the reset timeout
    b.record_success()
    log.append(b.state)
    return log


def test_breaker_state_machine_under_a_fake_clock():
    assert drive_breaker(pf) == drive_breaker(rf)
    assert drive_breaker(pf)[-1] == "closed"


def test_classification_matches_and_cuda_errors_are_permanent():
    cases = ["InjectedIOError", "InjectedUnavailable", "InjectedOOM",
             "InjectedCrash", "TransientError", "PermanentError",
             "DeviceOOM"]
    for cls in cases:
        assert (pf.classify(getattr(pf.errors, cls)("x"))
                == rf.classify(getattr(rf.errors, cls)("x"))), cls
    for exc in (FileNotFoundError("x"), ConnectionError("x"), OSError("x"),
                TimeoutError("x"), ValueError("x"), RuntimeError("x")):
        assert pf.classify(exc) == rf.classify(exc), exc
    # the card's own failures: an OOM is an OOM, a CUDA error is sticky
    assert pf.classify(torch.OutOfMemoryError("cuda oom")) == "oom"
    assert pf.classify(torch.AcceleratorError("illegal address")) == "permanent"
    b = pf.CircuitBreaker("card", failure_threshold=1)
    for exc in (torch.OutOfMemoryError("oom"), torch.AcceleratorError("bad")):
        calls = []

        def boom(exc=exc):
            calls.append(1)
            raise exc

        with pytest.raises(type(exc)):
            pf.retry_call(boom, policy=pf.RetryPolicy(), label="t", breaker=b,
                          sleep=lambda s: None)
        assert len(calls) == 1 and b.state == "closed"


# -- served recovery attribution ----------------------------------------------

def serve_under_plan(pkg_name, ds, route, plan_rules, batch_seed, q=8):
    """Write a small batch (so the first window reloads residency), then
    serve `q` single-request kNN windows under the plan. Returns the
    answers, the new ServeEvents' (retries, fault_injected,
    breaker_state), the fire log and the clean answers (no plan)."""
    pkg = PKG[pkg_name]
    f = pkg["faults"]
    src = ds.get_feature_source("faulty")
    src.write(pkg["fb"].from_pydict(src.sft, rows(50, batch_seed)))
    rng = np.random.default_rng(batch_seed)
    qx, qy = rng.uniform(-100, 100, q), rng.uniform(-50, 50, q)
    svc = pkg["service"](ds, pkg["config"](max_wait_ms=0.0, **ROUTES[route]))
    n0 = len(ds.audit.snapshot())
    plan = f.FaultPlan(rules=[f.FaultRule(**r) for r in plan_rules], seed=3)
    try:
        with f.active(plan) as h:
            got = [svc.knn("faulty", CQL, qx[i:i + 1], qy[i:i + 1], k=5
                           ).result(timeout=120) for i in range(q)]
            log = h.fire_log()
    finally:
        svc.close(drain=True)
    events = [(e.retries, e.fault_injected, e.breaker_state)
              for e in ds.audit.snapshot()[n0:]
              if isinstance(e, pkg["event"])]
    clean = [src.knn(CQL, qx[i:i + 1], qy[i:i + 1], k=5) for i in range(q)]
    return got, events, log, clean


FLAKY = [dict(site="device.transfer", error="io", every=2),
         dict(site="fs.read_partition", error="io", every=3)]


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_serve_events_charge_retries_and_faults_as_the_reference(catalogs,
                                                                 route):
    seed = 100 + sorted(ROUTES).index(route)
    out = {name: serve_under_plan(name, catalogs[name], route, FLAKY, seed)
           for name in ("ref", "port")}
    got, events, log, clean = out["port"]
    assert events == out["ref"][1]
    assert log == out["ref"][2]
    assert len(events) == len(got) and log
    assert sum(e[0] for e in events) == sum(e[1] for e in events) == len(log)
    for (d, i, _), (cd, ci, _) in zip(got, clean):
        np.testing.assert_array_equal(d, cd)
        np.testing.assert_array_equal(i, ci)
    for (d, _, b), (rd, _, rb) in zip(got, out["ref"][0]):
        np.testing.assert_allclose(d, rd, rtol=1e-5, atol=1.0)


def wire(pkg_name, ds, docs):
    pkg = PKG[pkg_name]
    svc = pkg["service"](ds, pkg["config"](**ROUTES["pipelined"]))
    out = []
    pkg["serve_lines"](ds, (json.dumps(d) for d in docs), out.append,
                       service=svc)
    return [json.loads(o) for o in out]


def test_open_breaker_answers_unavailable_and_a_probe_recovers(catalogs):
    knn = {"op": "knn", "typeName": "faulty", "cql": CQL, "x": [1.5],
           "y": [2.5], "k": 4}
    answers = {}
    for name in ("ref", "port"):
        f = PKG[name]["faults"]
        f.BREAKERS.configure("device", failure_threshold=2,
                             reset_timeout_s=0.3)
        plan = f.FaultPlan(rules=[f.FaultRule(site="device.transfer",
                                              error="io", every=1)])
        with f.active(plan):
            down = wire(name, catalogs[name], [dict(knn, id="a")])
        assert f.BREAKERS.states()["device"] == "open"
        time.sleep(0.35)
        up = wire(name, catalogs[name], [dict(knn, id="b")])
        assert f.BREAKERS.states()["device"] == "closed"
        answers[name] = (down, up)
    (down, up), (rdown, rup) = answers["port"], answers["ref"]
    assert down[0]["error"] == "unavailable" and not down[0]["ok"]
    assert 0 < down[0]["retryAfterS"] <= 0.3
    strip = lambda d: {k: v for k, v in d.items()  # noqa: E731
                       if k not in ("retryAfterS", "message")}
    assert strip(down[0]) == strip(rdown[0])
    assert up[0]["ok"] and up[0]["id"] == "b"
    assert sorted(up[0]) == sorted(rup[0])


# -- the storage boundary -----------------------------------------------------

@pytest.mark.parametrize("op", ["write", "delete", "compact"])
def test_failed_manifest_commit_rolls_back(tmp_path, op):
    ds = PDataStore(str(tmp_path), device="cpu")
    sft = PSFT.from_spec("faulty", SPEC)
    src = ds.create_schema(sft)
    src.write(PFB.from_pydict(sft, rows(64, 9)))
    storage = src.storage
    extra = PFB.from_pydict(sft, rows(16, 6))
    if op == "compact":
        src.write(extra)  # a second file in each partition
    before = storage.count
    files = lambda: {k: [e["file"] for e in v]  # noqa: E731
                     for k, v in storage.manifest_snapshot().items()}
    snap = files()
    actions = {"write": lambda: src.write(extra),
               "delete": lambda: src.delete_features("name = 'a'"),
               "compact": storage.compact}
    plan = pf.FaultPlan(rules=[pf.FaultRule(site="fs.write_manifest",
                                            error="io", nth_call=1)])
    with pf.active(plan):
        with pytest.raises(OSError):
            actions[op]()
    # memory matches disk: the failed mutation is not visible
    assert storage.count == before and files() == snap
    with open(os.path.join(storage.root, "metadata.json")) as fh:
        assert {k: [e["file"] for e in v]
                for k, v in json.load(fh)["manifest"].items()} == snap
    for name, fs in snap.items():
        for fn in fs:
            assert os.path.exists(os.path.join(storage.root, name, fn))
    # a retry applies exactly once
    res = actions[op]()
    if op == "write":
        assert storage.count == before + 16
    elif op == "delete":
        assert res > 0 and storage.count == before - res
    else:
        assert res > 0 and storage.count == before


def test_a_fault_while_a_ring_arms_leaves_no_capture(tmp_path):
    from geomesa_tpu_torch.compilecache.registry import registry

    ds = PDataStore(str(tmp_path), use_device_cache=True, device="cpu")
    sft = PSFT.from_spec("faulty", SPEC)
    src = ds.create_schema(sft)
    src.write(PFB.from_pydict(sft, rows(3000, 9)))
    svc = PService(ds, PConfig(max_wait_ms=0.0))
    plan = pf.FaultPlan(rules=[pf.FaultRule(site="device.transfer",
                                            error="io", every=1)])
    try:
        with pf.active(plan) as h:
            fut = svc.knn("faulty", CQL, [1.0], [2.0], k=5)
            with pytest.raises(OSError) as ei:
                fut.result(timeout=120)
            assert len(h.fire_log()) == 3  # three attempts, then typed
        assert pf.is_typed(ei.value)
        assert not [c for c in registry.held()
                    if c.owner_id == id(src.planner)]
        assert svc.pipeline.ring.stats()["armed"] == 0
        d, i, _ = svc.knn("faulty", CQL, [1.0], [2.0], k=5).result(timeout=120)
        assert svc.pipeline.ring.stats()["armed"] == 1
    finally:
        svc.close(drain=True)
    ed, ei2, _ = src.knn(CQL, [1.0], [2.0], k=5)
    np.testing.assert_array_equal(d, ed)
    np.testing.assert_array_equal(i, ei2)
