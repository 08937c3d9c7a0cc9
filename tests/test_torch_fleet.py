"""The port's fleet, router and placement against the JAX package's, on
the CPU (JAX tests/test_fleet.py and the placement controller).

Each of the JAX file's ten cases runs in both packages on the same model
texts (3 and 6 iterations of 15 leaves, trained by the port) and the
same rows, on the f64 lane: the two-phase publish that one replica's
failed warm aborts everywhere, fleet-wide rollback, retry onto another
replica when one dies between its health check and the dispatch, a
hedged race counted once, the deadline's 504 mid-hedge, ejection and
readmission of a wedged replica, ``/healthz``'s restart and wedge
evidence, the watchdog's events in the merged event log (obs/agg.py),
``ServeHTTP`` over a router, and shedding when every replica is full.
The answers of each pair are equal bit for bit, with the same version
tags.  The placement controller's ``assign`` and ``step`` take the same
decisions as the JAX controller's on the same synthetic signals.

Every test that starts a thread joins it with a timeout, and every fault
plan is disarmed by its ``inject`` block.
"""

import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import lightgbmv1_tpu as lj
from lightgbmv1_tpu import serve as jserve
from lightgbmv1_tpu.obs import agg as jagg
from lightgbmv1_tpu.serve import placement as jplacement
from lightgbmv1_tpu.utils import faults as jfaults

import lightgbmv1_tpu_torch as lt
from lightgbmv1_tpu_torch import serve as tserve
from lightgbmv1_tpu_torch.obs import agg as tagg
from lightgbmv1_tpu_torch.serve import placement as tplacement
from lightgbmv1_tpu_torch.utils import faults as tfaults

from conftest import make_binary_problem

PKG = {"t": (tserve, tfaults, tagg), "j": (jserve, jfaults, jagg)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def texts():
    """The JAX test's two models (3 and 6 iterations of 15 leaves on
    1,000 rows of 6 features), trained by the port."""
    X, y = make_binary_problem(1000, 6, seed=1)
    p = {"objective": "binary", "num_leaves": 15, "min_data_in_leaf": 5,
         "verbosity": -1}
    out = [lt.train(p, lt.Dataset(X, label=y), n, device="cpu")
           .model_to_string() for n in (3, 6)]
    return out, X


def _booster(tag, text):
    return (lt.Booster(model_str=text, device="cpu") if tag == "t"
            else lj.Booster(model_str=text))


def _cfg(tag, **over):
    kw = dict(max_batch_rows=64, max_batch_delay_ms=1.0, f64_scores=True,
              predictor_kwargs={"bucket_min": 64})
    kw.update(over)
    return PKG[tag][0].ServeConfig(**kw)


def _fleet(tag, text, n=2, **over):
    serve = PKG[tag][0]
    kw = {"device": "cpu"} if tag == "t" else {}
    return serve.Fleet(_booster(tag, text), n_replicas=n,
                       config=_cfg(tag, **over), **kw)


def _server(tag, text, name, **over):
    serve = PKG[tag][0]
    kw = {"device": "cpu"} if tag == "t" else {}
    return serve.Server(_booster(tag, text), config=_cfg(tag, **over),
                        name=name, **kw)


def _both(scenario, *args):
    """The scenario's observations in each package; equal bit for bit."""
    out = {tag: scenario(tag, *args) for tag in ("t", "j")}
    for key in out["j"]:
        a, b = out["t"][key], out["j"][key]
        if isinstance(b, np.ndarray):
            assert np.array_equal(a, b), key
        else:
            assert a == b, (key, a, b)
    return out["t"]


def _post(port, rows, timeout=30):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/predict",
        data=json.dumps({"rows": np.asarray(rows).tolist()}).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=30) as r:
        return json.loads(r.read())


# ---------------------------------------------------------------------------
# two-phase fleet publish
# ---------------------------------------------------------------------------


def test_fleet_two_phase_publish_abort_rolls_nobody(texts):
    """One replica's failed warm aborts the whole publish in both
    packages: no replica swaps, every replica answers v1 bit for bit,
    the burned sequence number keeps the tags aligned, and the next
    clean publish lands one tag fleet-wide."""
    (t1, t2), X = texts

    def scenario(tag):
        serve, faults, _ = PKG[tag]
        obs = {}
        with _fleet(tag, t1, n=3) as fleet:
            obs["v0"] = fleet.version()
            with faults.inject(faults.FaultSpec("publish_warm",
                                                mode="raise", match="r1:")):
                with pytest.raises(serve.FleetPublishError) as ei:
                    fleet.publish(_booster(tag, t2))
            obs["causes"] = sorted(ei.value.causes)
            obs["after_abort"] = fleet.version()
            res = [r.submit(X[:8]) for r in fleet.replicas]
            obs["abort_tags"] = [x.version for x in res]
            obs["abort_vals"] = np.stack([x.values for x in res])
            obs["tag"] = fleet.publish(_booster(tag, t2))
            obs["version"] = fleet.version()
            obs["vals"] = np.stack([r.submit(X[:8]).values
                                    for r in fleet.replicas])
        return obs

    obs = _both(scenario)
    assert obs["v0"] == obs["after_abort"] == "v1"
    assert obs["causes"] == ["r1"] and obs["abort_tags"] == ["v1"] * 3
    assert obs["version"] == obs["tag"]
    want1 = _booster("t", t1).predict(X[:8], raw_score=True)
    want2 = _booster("t", t2).predict(X[:8], raw_score=True)
    for v1, v2 in zip(obs["abort_vals"], obs["vals"]):
        assert np.array_equal(v1[:, 0], want1)
        assert np.array_equal(v2[:, 0], want2)


def test_fleet_rollback_is_fleet_wide(texts):
    (t1, t2), X = texts

    def scenario(tag):
        with _fleet(tag, t1) as fleet:
            fleet.publish(_booster(tag, t2))
            tags = [fleet.version()]
            fleet.rollback()
            tags.append(fleet.version())
            vals = np.stack([r.submit(X[:4]).values
                             for r in fleet.replicas])
        return {"tags": tags, "vals": vals}

    obs = _both(scenario)
    assert obs["tags"] == ["v2", "v1"]
    want1 = _booster("t", t1).predict(X[:4], raw_score=True)
    assert all(np.array_equal(v[:, 0], want1) for v in obs["vals"])


# ---------------------------------------------------------------------------
# router: retry / hedging / deadline edge cases
# ---------------------------------------------------------------------------


def test_retry_replica_dies_between_health_check_and_dispatch(texts):
    """r0 closes after its last health check and before the request
    reaches it: the router retries onto r1 with no error and ejects r0
    at once."""
    (t1, _), X = texts

    def scenario(tag):
        serve = PKG[tag][0]
        with _fleet(tag, t1) as fleet:
            with serve.Router(fleet, serve.RouterConfig(
                    health_period_ms=5000.0, retry_max=2)) as router:
                fleet.replica("r0").close()
                res = router.submit(X[:4])
                snap = router.metrics_snapshot()
        return {"vals": res.values, "version": res.version,
                "retries": snap["retries"], "errors": snap["errors"],
                "r0": snap["router"]["replicas"]["r0"]}

    obs = _both(scenario)
    assert np.array_equal(obs["vals"][:, 0], _booster("t", t1).predict(
        X[:4], raw_score=True))
    assert obs["retries"] >= 1 and obs["errors"] == 0
    assert obs["r0"]["healthy"] is False and obs["r0"]["ejections"] == 1


def test_hedged_race_first_wins_no_double_count(texts):
    """The primary stalls on its link (``rpc_delay``), the hedge answers
    first: one completion, one hedge, one hedge win, and the loser's
    late answer changes nothing (metrics and SLO)."""
    (t1, _), X = texts
    stall_s = 0.4

    def scenario(tag):
        serve, faults, _ = PKG[tag]
        with _fleet(tag, t1) as fleet:
            with serve.Router(fleet, serve.RouterConfig(
                    health_period_ms=5000.0, hedge_ms=30.0)) as router:
                router.submit(X[:4])
                base = router.metrics_snapshot()
                with faults.inject(faults.FaultSpec(
                        "rpc_delay", mode="stall", stall_s=stall_s)):
                    t0 = time.monotonic()
                    res = router.submit(X[:4])
                    dt = time.monotonic() - t0
                snap = router.metrics_snapshot()
                time.sleep(stall_s + 0.2)
                snap2 = router.metrics_snapshot()
                fast = router.slo.snapshot()["availability"]["windows"][
                    "fast"]
        return {"vals": res.values, "fast": dt < stall_s,
                "hedges": snap["router"]["hedges"]
                - base["router"]["hedges"],
                "wins": snap["router"]["hedge_wins"]
                - base["router"]["hedge_wins"],
                "completed": snap["completed"] - base["completed"],
                "late": snap2["completed"] - snap["completed"],
                "errors": snap2["errors"] + snap2["timeouts"],
                "slo": (fast["total"] == snap2["completed"],
                        fast["errors"])}

    obs = _both(scenario)
    assert np.array_equal(obs["vals"][:, 0], _booster("t", t1).predict(
        X[:4], raw_score=True))
    assert obs["fast"] and obs["hedges"] == obs["wins"] == 1
    assert obs["completed"] == 1 and obs["late"] == 0
    assert obs["errors"] == 0 and obs["slo"] == (True, 0)


def test_deadline_exhaustion_mid_hedge_is_504_not_500(texts):
    """Every attempt stalls past the deadline: RequestTimeout in process
    and 504 with ``timeout: true`` over HTTP, while hedges still run."""
    (t1, _), X = texts

    def scenario(tag):
        serve, faults, _ = PKG[tag]
        obs = {}
        with _fleet(tag, t1) as fleet:
            with serve.Router(fleet, serve.RouterConfig(
                    health_period_ms=5000.0, hedge_ms=25.0,
                    deadline_ms=150.0)) as router:
                router.submit(X[:4])
                with faults.inject(faults.FaultSpec(
                        "rpc_delay", mode="stall", count=2, stall_s=1.0)):
                    t0 = time.monotonic()
                    with pytest.raises(serve.RequestTimeout):
                        router.submit(X[:4])
                    obs["in_time"] = time.monotonic() - t0 < 0.9
                obs["timeouts"] = router.metrics_snapshot()["timeouts"] >= 1
                http = serve.ServeHTTP(router).start()
                try:
                    with faults.inject(faults.FaultSpec(
                            "rpc_delay", mode="stall", count=2,
                            stall_s=1.0)):
                        code, body = _post(http.port, X[:2], timeout=10)
                finally:
                    http.shutdown()
                obs["http"] = (code, body.get("timeout"))
                time.sleep(1.1)     # the stalled attempts drain
        return obs

    obs = _both(scenario)
    assert obs == {"in_time": True, "timeouts": True, "http": (504, True)}


def test_router_health_ejection_and_readmission(texts):
    """A wedged r0 (its batch stalled past the watchdog) is ejected by
    the health poller with no client error, and readmitted once the
    stall drains."""
    (t1, _), X = texts

    def scenario(tag):
        serve, faults, _ = PKG[tag]
        answers = []
        with _fleet(tag, t1, watchdog_ms=80.0) as fleet:
            with serve.Router(fleet, serve.RouterConfig(
                    health_period_ms=10.0, eject_after=2, readmit_after=2,
                    retry_max=2)) as router:
                router.submit(X[:4])
                errors = 0
                with faults.inject(faults.FaultSpec(
                        "replica_wedge", mode="stall", stall_s=0.5,
                        match="r0")):
                    t0 = time.monotonic()
                    while time.monotonic() - t0 < 0.6:
                        try:
                            answers.append(router.submit(X[:4]).values)
                        except Exception:   # noqa: BLE001 — counted
                            errors += 1
                        time.sleep(0.03)
                ejected = router.replica_states()["r0"]["ejections"] >= 1
                deadline = time.monotonic() + 3.0
                while time.monotonic() < deadline and \
                        not router.replica_states()["r0"]["healthy"]:
                    time.sleep(0.05)
                st = router.replica_states()["r0"]
        return {"errors": errors, "ejected": ejected,
                "readmitted": st["healthy"] and st["readmissions"] >= 1,
                "answers": answers}

    want = _booster("t", t1).predict(X[:4], raw_score=True)
    out = {}
    for tag in ("t", "j"):
        obs = scenario(tag)
        assert obs["answers"] and all(np.array_equal(v[:, 0], want)
                                      for v in obs.pop("answers"))
        out[tag] = obs
    assert out["t"] == out["j"] == {"errors": 0, "ejected": True,
                                    "readmitted": True}


# ---------------------------------------------------------------------------
# /healthz observability and the merged event log
# ---------------------------------------------------------------------------


def test_healthz_surfaces_restarts_and_wedge_timestamp(texts):
    """A replica's health carries the router's ejection evidence: the
    dispatcher's restart count and the last wedge's wall time."""
    (t1, _), X = texts

    def scenario(tag):
        faults = PKG[tag][1]
        srv = _server(tag, t1, "r9", watchdog_ms=80.0)
        try:
            srv.submit(X[:4])
            h0 = srv.health()
            t_before = time.time()
            with faults.inject(faults.FaultSpec(
                    "replica_wedge", mode="stall", stall_s=0.4)):
                try:
                    srv.submit(X[:4])
                except Exception:   # noqa: BLE001 — the watchdog's 503
                    pass
            time.sleep(0.1)
            wedge = srv.health()["last_wedge_unix"]
            with faults.inject(faults.FaultSpec("dispatch",
                                                mode="exit_thread")):
                try:
                    srv.submit(X[:4])
                except Exception:   # noqa: BLE001
                    pass
            deadline = time.monotonic() + 3.0
            while time.monotonic() < deadline and \
                    srv.health()["dispatcher_restarts"] < 1:
                time.sleep(0.05)
            h1 = srv.health()
        finally:
            srv.close()
        return {"h0": (h0["dispatcher_restarts"], h0["last_wedge_unix"],
                       h0["wedged"], h0["name"]),
                "wedge": wedge is not None and wedge >= t_before,
                "restarts": h1["dispatcher_restarts"] >= 1,
                "keys": sorted(set(h1) - {"server_version"})}

    obs = _both(scenario)
    assert obs["h0"] == (0, None, False, "r9")
    assert obs["wedge"] and obs["restarts"]


def test_breaker_watchdog_events_reach_fleet_merged_log(texts, tmp_path):
    """The watchdog-stall and dispatcher-restart events of a replica
    reach the merged event log of each package's obs/agg."""
    (t1, _), X = texts

    def scenario(tag):
        faults, agg = PKG[tag][1], PKG[tag][2]
        srv = _server(tag, t1, "rA", watchdog_ms=80.0)
        try:
            srv.submit(X[:4])
            with faults.inject(faults.FaultSpec(
                    "replica_wedge", mode="stall", stall_s=0.4)):
                try:
                    srv.submit(X[:4])
                except Exception:   # noqa: BLE001
                    pass
            with faults.inject(faults.FaultSpec("dispatch",
                                                mode="exit_thread")):
                try:
                    srv.submit(X[:4])
                except Exception:   # noqa: BLE001
                    pass
            deadline = time.monotonic() + 3.0
            while time.monotonic() < deadline and \
                    srv.health()["dispatcher_restarts"] < 1:
                time.sleep(0.05)
        finally:
            srv.close()
        out_dir = tmp_path / tag
        agg.export_process_artifacts(str(out_dir), label="replica-rA",
                                     registry=srv.metrics.registry)
        summary = agg.aggregate_dir(str(out_dir))
        with open(summary["merged_metrics"]) as fh:
            merged = json.load(fh)
        kinds = {e.get("kind") for e in merged.get("events", [])}
        return {"kinds": {"serve.watchdog_stall",
                          "serve.dispatcher_restart"} <= kinds,
                "sources": summary["sources"],
                "processes": summary["metrics_processes"]}

    obs = _both(scenario)
    assert obs["kinds"] and obs["sources"] == ["replica-rA"]


def test_router_http_front_end_serves_fleet(texts):
    """ServeHTTP serves a router as a server: /predict, /healthz,
    /metrics, /slo, /tenants and /drift answer with the fleet's view."""
    (t1, _), X = texts

    def scenario(tag):
        serve = PKG[tag][0]
        with _fleet(tag, t1) as fleet:
            with serve.Router(fleet, serve.RouterConfig(
                    health_period_ms=20.0)) as router:
                http = serve.ServeHTTP(router).start()
                try:
                    code, out = _post(http.port, X[:3])
                    health = _get(http.port, "/healthz")
                    m = _get(http.port, "/metrics")
                    slo = _get(http.port, "/slo")
                    ten = _get(http.port, "/tenants")
                    drift = _get(http.port, "/drift")
                finally:
                    http.shutdown()
        return {"code": code, "version": out["version"],
                "vals": np.asarray(out["values"]),
                "health": (health["ok"], sorted(health["healthy_replicas"]),
                           health["replicas"]["r0"]["version"]),
                "metrics": (m["completed"] >= 1, sorted(m["router"])),
                "slo": slo["version"],
                "tenants": (sorted(ten), ten["versions"]),
                "drift": (drift["armed"], sorted(drift["replicas"]))}

    obs = _both(scenario)
    assert obs["code"] == 200 and obs["version"] == obs["slo"] == "v1"
    assert np.array_equal(obs["vals"][:, 0], _booster("t", t1).predict(
        X[:3], raw_score=True))
    assert obs["health"] == (True, ["r0", "r1"], "v1")
    assert obs["metrics"] == (True, ["hedge_wins", "hedges", "replicas"])


def test_overload_on_all_replicas_surfaces_as_shed(texts):
    """When every replica sheds, the router raises ServerOverloaded and
    counts a shed, not an error."""
    (t1, _), X = texts

    def scenario(tag):
        serve = PKG[tag][0]
        with _fleet(tag, t1, max_batch_rows=8, queue_depth_rows=8,
                    max_batch_delay_ms=50.0) as fleet:
            with serve.Router(fleet, serve.RouterConfig(
                    health_period_ms=5000.0, retry_max=2)) as router:
                def fill_one():
                    try:
                        router.submit(X[:8])
                    except serve.ServeError:     # shed: the queue is full
                        pass

                fill = [threading.Thread(target=fill_one) for _ in range(2)]
                for th in fill:
                    th.start()
                time.sleep(0.05)
                with pytest.raises(serve.ServerOverloaded):
                    router.submit(X[:9])
                shed = router.metrics_snapshot()["shed"] >= 1
                for th in fill:
                    th.join(timeout=10)
                hung = any(th.is_alive() for th in fill)
        return {"shed": shed, "hung": hung}

    assert _both(scenario) == {"shed": True, "hung": False}


# ---------------------------------------------------------------------------
# placement
# ---------------------------------------------------------------------------


class _Replica:
    def __init__(self, name, view):
        self.name, self._view = name, view

    def tenants_snapshot(self):
        return {"replica": self.name, "tenants": self._view[self.name]}


class _Fleet:
    """The placement controller's view of a fleet: replicas whose
    ``tenants_snapshot`` reads a shared table of synthetic signals."""

    def __init__(self, names, tenants):
        self.view = {n: {} for n in names}
        self.replicas = [_Replica(n, self.view) for n in names]
        self._tenants = tenants

    def tenant_names(self):
        return ["", *self._tenants]

    def set(self, tenant, replica, **sig):
        base = {"queue_rows": 0, "burn_rate": 0.0, "occupancy": 0.0,
                "slo_page": False}
        self.view[replica][tenant] = {**base, **sig}


class _Router:
    def __init__(self, names):
        self._names, self._map = set(names), {}

    def set_placement(self, tenant, names):
        names = tuple(names or ())
        assert set(names) <= self._names
        if names:
            self._map[tenant] = names
        else:
            self._map.pop(tenant, None)

    def placement(self):
        return dict(self._map)


def _controller(mod, fleet, **cfg):
    return mod.PlacementController(fleet, _Router(
        [r.name for r in fleet.replicas]), mod.PlacementConfig(**cfg))


def test_placement_config_and_assign_match_jax():
    """``assign`` pins the named tenants round-robin on the same subsets
    as the JAX controller (the default tenant stays everywhere), leaves
    pinned ones where they are, and both packages refuse the same
    configurations."""
    names = ["r0", "r1", "r2", "r3"]
    out = {}
    for tag, mod in (("t", tplacement), ("j", jplacement)):
        fleet = _Fleet(names, ["a", "b", "c", "d", "e"])
        ctl = _controller(mod, fleet, replicas_per_tenant=2)
        first = ctl.assign()
        ctl.router.set_placement("f", ["r3"])
        fleet._tenants.append("f")
        second = ctl.assign()
        errors = []
        for bad in ({"burn_threshold": 0}, {"occupancy_frac": 1.5},
                    {"replicas_per_tenant": 5}):
            try:
                _controller(mod, fleet, **bad)
            except ValueError as e:
                errors.append(str(e))
        out[tag] = (first, second, errors)
    assert out["t"] == out["j"]
    assert out["t"][0]["a"] == ["r0", "r1"] and "" not in out["t"][0]
    assert len(out["t"][2]) == 3


def test_placement_step_decisions_match_jax():
    """Over a scripted run of signals — a burning tenant, an overfull
    one, a paging one, the cooldown and the churn bound — ``signals`` and
    every ``step``'s move records equal the JAX controller's, and each
    move is a ``placement.move`` event."""
    from lightgbmv1_tpu_torch.obs import events as tevents

    names = ["r0", "r1", "r2"]
    script = [
        # (now, {(tenant, replica): signals}) applied before the step
        (0.0, {("a", "r0"): {"burn_rate": 3.0, "queue_rows": 40},
               ("a", "r1"): {"queue_rows": 10},
               ("b", "r1"): {"occupancy": 0.9, "queue_rows": 30},
               ("b", "r2"): {"queue_rows": 5}}),
        (1.0, {}),                                   # churn bound / cooldown
        (5.0, {("b", "r2"): {"slo_page": True, "burn_rate": 1.0}}),
        (40.0, {("a", "r2"): {"burn_rate": 9.0, "queue_rows": 50}}),
        (41.0, {("a", "r2"): {"burn_rate": 0.0, "queue_rows": 0},
                ("a", "r0"): {"burn_rate": 0.0}}),
    ]
    out = {}
    for tag, mod in (("t", tplacement), ("j", jplacement)):
        fleet = _Fleet(names, ["a", "b"])
        for t in ("a", "b"):
            for r in names:
                fleet.set(t, r)
        ctl = _controller(mod, fleet, replicas_per_tenant=2,
                          cooldown_s=30.0, max_moves_per_step=1)
        steps = [ctl.assign()]
        mark = tevents.seq()
        for now, sigs in script:
            for (t, r), sig in sigs.items():
                fleet.set(t, r, **sig)
            steps.append((ctl.signals(), ctl.step(now=now)))
        out[tag] = (steps, ctl.moves)
        if tag == "t":
            moved = [e for e in tevents.tail(since_seq=mark)
                     if e["kind"] == "placement.move"]
            assert len(moved) == ctl.moves
    assert out["t"] == out["j"]
    assert out["t"][1] >= 2
