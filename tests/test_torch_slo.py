"""The port's SLO engine against the JAX package's: the cases of
``tests/test_slo.py`` run through both engines.  Both read their own
metrics registry, so each case feeds both registries the same counter and
histogram sequences and drives both engines on the same injected clock;
the alert transitions, the ``mxtpu-health/1`` documents, the alert
metrics, the ``alert`` flight events, the fleet evaluator's events and
the rule catalog must be equal, and each case's hand-computed readings
hold for the port."""
import copy
import json

import pytest

from mxnet_tpu import telemetry as jtel
from mxnet_tpu.telemetry import slo as jslo
from mxnet_tpu_torch import telemetry as ttel
from mxnet_tpu_torch.telemetry import slo as tslo

PKGS = (("jax", jtel, jslo), ("torch", ttel, tslo))


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for k in ("MXNET_TPU_SLO_RULES", "MXNET_TPU_SLO", "MXNET_TPU_SLO_FAST_S",
              "MXNET_TPU_SLO_SLOW_S", "MXNET_TPU_SLO_LATENCY_MS",
              "MXNET_TPU_PROCESS_ID"):
        monkeypatch.delenv(k, raising=False)
    jtel.reset()
    ttel.reset()
    yield
    jtel.reset()
    ttel.reset()


def both(case):
    """``case(telemetry, slo)`` in each package; the results must be
    equal.  Returns the port's."""
    out = {name: case(tel, slo) for name, tel, slo in PKGS}
    assert out["torch"] == out["jax"]
    return out["torch"]


def _rules(slo, *names, **overrides):
    table = [r for r in slo.load_rules(spec="") if r["name"] in names]
    assert len(table) == len(names)
    for r in table:
        r.update(overrides.get(r["name"], {}))
    return table


def _alert_events(tel):
    """The ``alert`` flight events without their clock and sequence."""
    return [{k: v for k, v in e.items() if k not in ("ts", "seq")}
            for e in tel.flight.events() if e["kind"] == "alert"]


def _state(tel, eng, now):
    """What an engine shows after a tick: every alert's machine, its
    health document, the alert metrics and the alert flight events."""
    return {"alerts": eng.alerts(now=now), "health": eng.health(now=now),
            "metrics": {k: v for k, v in tel.REGISTRY.flat().items()
                        if k.startswith(("mxtpu_alert", "mxtpu_slo_",
                                         "mxtpu_health_"))},
            "flight": _alert_events(tel)}


# ------------------------------------------------------------ rule catalog

def test_rule_catalog_equals_jax():
    assert tslo.RULES == jslo.RULES
    assert (tslo.TYPES, tslo.SEVERITIES, tslo.STATES, tslo.HEALTH_SCHEMA) \
        == (jslo.TYPES, jslo.SEVERITIES, jslo.STATES, jslo.HEALTH_SCHEMA)
    assert tslo.load_rules(spec="") == jslo.load_rules(spec="")
    assert tslo.selfcheck_rules() == [] == jslo.selfcheck_rules()
    # every metric a rule reads is one the port's catalog declares
    for r in tslo.RULES:
        for key in ("metric", "bad_metric", "total_metric", "denom_metric"):
            if r.get(key):
                assert r[key] in ttel.CATALOG


@pytest.mark.parametrize("breakage", ["severity", "objective", "duplicate"])
def test_selfcheck_catches_bad_rules(breakage):
    def case(tel, slo):
        bad = copy.deepcopy(slo.RULES)
        if breakage == "severity":
            bad[0]["severity"] = "apocalyptic"
        elif breakage == "objective":
            bad[1]["objective"] = 1.0
        else:
            bad.append(dict(bad[0]))
        return slo.selfcheck_rules(bad)
    problems = both(case)
    assert any({"duplicate": "name"}.get(breakage, breakage) in p
               for p in problems)


# ------------------------------------------------------- burn-rate windows

def _shed_engine(slo, fast=10.0, slow=60.0):
    return slo.SloEngine(rules=_rules(
        slo, "serve_shed_burn",
        serve_shed_burn={"fast_s": fast, "slow_s": slow,
                         "resolve_for_s": 0.0}))


def test_burn_rate_hand_computed():
    def case(tel, slo):
        eng = _shed_engine(slo)
        req = tel.counter("mxtpu_serve_requests_total")
        eng.tick(now=0.0)
        req.labels(outcome="shed").inc(90)
        req.labels(outcome="ok").inc(10)
        eng.tick(now=5.0)
        return _state(tel, eng, 5.0)
    st = both(case)
    al = st["alerts"][0]
    assert al["state"] == "firing"
    assert al["burn_fast"] == pytest.approx(90.0)
    assert al["burn_slow"] == pytest.approx(90.0)
    assert st["health"]["status"] == "critical"
    assert st["health"]["firing"][0]["rule"] == "serve_shed_burn"


def test_burn_rate_below_factor_does_not_fire():
    def case(tel, slo):
        eng = _shed_engine(slo)
        req = tel.counter("mxtpu_serve_requests_total")
        eng.tick(now=0.0)
        req.labels(outcome="shed").inc(1)
        req.labels(outcome="ok").inc(99)
        eng.tick(now=5.0)
        return _state(tel, eng, 5.0)
    assert both(case)["alerts"][0]["state"] == "inactive"


def test_burn_rate_needs_both_windows():
    def case(tel, slo):
        eng = _shed_engine(slo, fast=10.0, slow=100.0)
        req = tel.counter("mxtpu_serve_requests_total")
        eng.tick(now=0.0)
        req.labels(outcome="ok").inc(10000)
        for t in range(10, 101, 10):
            eng.tick(now=float(t))
        req.labels(outcome="shed").inc(90)
        req.labels(outcome="ok").inc(10)
        eng.tick(now=105.0)
        first = _state(tel, eng, 105.0)
        req.labels(outcome="shed").inc(400)
        eng.tick(now=110.0)
        return first, _state(tel, eng, 110.0)
    first, second = both(case)
    assert first["alerts"][0]["burn_fast"] == pytest.approx(90.0)
    assert first["alerts"][0]["burn_slow"] < 2.0
    assert first["alerts"][0]["state"] == "inactive"
    assert second["alerts"][0]["burn_slow"] > 2.0
    assert second["alerts"][0]["state"] == "firing"


def test_burn_rate_no_traffic_stays_quiet():
    def case(tel, slo):
        eng = _shed_engine(slo)
        for t in range(0, 30, 5):
            eng.tick(now=float(t))
        return _state(tel, eng, 30.0)
    st = both(case)
    assert st["alerts"][0]["state"] == "inactive"
    assert st["health"]["status"] == "healthy"


def test_latency_burn_from_histogram_buckets():
    def case(tel, slo):
        eng = slo.SloEngine(rules=_rules(
            slo, "serve_p99_latency_burn",
            serve_p99_latency_burn={"fast_s": 10.0, "slow_s": 60.0}))
        h = tel.histogram("mxtpu_serve_request_seconds")
        eng.tick(now=0.0)
        for _ in range(100):
            h.labels(segment="total").observe(0.001)
        eng.tick(now=2.0)
        quiet = _state(tel, eng, 2.0)
        for _ in range(300):
            h.labels(segment="total").observe(10.0)
        eng.tick(now=4.0)
        return quiet, _state(tel, eng, 4.0)
    quiet, burning = both(case)
    assert quiet["alerts"][0]["state"] == "inactive"
    assert burning["alerts"][0]["state"] == "firing"
    assert burning["alerts"][0]["burn_fast"] == pytest.approx(75.0)


# ----------------------------------------------------- alert state machine

ADVANCES = {
    "debounce_up": [(True, 0.0, 5.0, 0.0), (True, 4.0, 5.0, 0.0),
                    (True, 5.0, 5.0, 0.0)],
    "pending_clears": [(True, 0.0, 10.0, 0.0), (False, 3.0, 10.0, 0.0)],
    "antiflap_down": [(True, 0.0, 0.0, 4.0), (False, 1.0, 0.0, 4.0),
                      (True, 2.0, 0.0, 4.0), (False, 5.0, 0.0, 4.0),
                      (False, 6.0, 0.0, 4.0)],
    "none_freezes": [(True, 0.0, 0.0, 30.0)] + [
        (None, float(t), 0.0, 30.0) for t in range(1, 200, 50)],
    "zero_for_s": [(True, 0.0, 0.0, 0.0)],
}
WANT = {
    "debounce_up": [["pending"], [], ["firing"]],
    "pending_clears": [["pending"], ["cleared"]],
    "antiflap_down": [["pending", "firing"], [], [], [], ["resolved"]],
    "none_freezes": [["pending", "firing"], [], [], [], []],
    "zero_for_s": [["pending", "firing"]],
}


@pytest.mark.parametrize("sequence", sorted(ADVANCES))
def test_alert_state_machine(sequence):
    def case(tel, slo):
        al = slo.Alert("r", "warn")
        steps = []
        for cond, now, for_s, resolve_for_s in ADVANCES[sequence]:
            steps.append(al.advance(cond, now, for_s, resolve_for_s))
        return steps, al.state, al.fired_ts, al.resolved_ts, \
            al.describe(10.0)
    steps, _state_, fired, resolved, _d = both(case)
    assert steps == WANT[sequence]
    if sequence == "antiflap_down":
        assert resolved == 6.0
    if sequence == "debounce_up":
        assert fired == 5.0


# ---------------------------------------------------------------- absence

def test_absence_arms_only_after_first_advance():
    def case(tel, slo):
        eng = slo.SloEngine(rules=_rules(
            slo, "train_heartbeat", train_heartbeat={"hold_s": 60.0}))
        step = tel.counter("mxtpu_step_total")
        seen = []
        for t in range(0, 500, 100):
            eng.tick(now=float(t))
        seen.append(_state(tel, eng, 400.0))
        step.inc()
        for t in (500.0, 559.0, 561.0):
            eng.tick(now=t)
            seen.append(_state(tel, eng, t))
        step.inc()
        eng.tick(now=562.0)
        seen.append(_state(tel, eng, 562.0))
        return seen
    seen = both(case)
    assert [s["alerts"][0]["state"] for s in seen] == [
        "inactive", "inactive", "inactive", "firing", "inactive"]
    assert seen[-1]["health"]["resolved"] == [
        {"rule": "train_heartbeat", "severity": "critical", "ago_s": 0.0}]


# ----------------------------------------------------------- fleet quorum

def _fleet_rule(quorum, field="ranks.lag", bound=0.5):
    return [dict(name="q", type="threshold", severity="warn",
                 scope="fleet", field=field, op=">", bound=bound,
                 quorum=quorum, summary="t", for_s=0.0,
                 resolve_for_s=0.0)]


def _rec(ts, **ranks):
    return {"kind": "step", "step": 1, "ts": ts,
            "ranks": {str(k): v for k, v in ranks.items()}}


@pytest.mark.parametrize("quorum,lags,fires", [
    ("any", (1.0, 0.0), True), ("all", (1.0, 0.0), False),
    ("all", (1.0, 2.0), True), (0.5, (1.0, 1.0, 0.0), True),
    (0.9, (1.0, 1.0, 0.0), False)])
def test_fleet_quorum(quorum, lags, fires):
    def case(tel, slo):
        fh = slo.FleetHealth(rules=_fleet_rule(quorum))
        rec = _rec(1.0, **{"r%d" % i: {"lag": v}
                           for i, v in enumerate(lags)})
        return fh.observe_step(rec), fh.verdict(now=1.0)
    events, verdict = both(case)
    assert [e["to"] for e in events] == (["firing"] if fires else [])
    assert verdict["status"] == ("degraded" if fires else "healthy")


def test_fleet_skew_rule_over_timeline():
    def case(tel, slo):
        fh = slo.FleetHealth(rules=_rules(
            slo, "fleet_skew",
            fleet_skew={"bound": 0.05, "resolve_for_s": 0.0}))
        out = []
        for step, ts, skew in ((1, 1.0, 0.01), (2, 2.0, 0.2),
                               (3, 3.0, None), (4, 4.0, 0.01)):
            rec = {"kind": "step", "step": step, "ts": ts}
            if skew is not None:
                rec["skew_s"] = skew
            out.append((fh.observe_step(rec), fh.verdict(now=ts)))
        return out
    out = both(case)
    assert [[e["to"] for e in ev] for ev, _v in out] == [
        [], ["firing"], [], ["resolved"]]
    assert out[1][0][0]["value"] == pytest.approx(0.2)
    assert [v["status"] for _e, v in out] == [
        "healthy", "degraded", "degraded", "healthy"]


def test_fleet_rank_missing_armed_to_fleet_size():
    def case(tel, slo):
        fh = slo.FleetHealth(rules=_rules(slo, "fleet_rank_missing"),
                             num_ranks=4)
        return [fh.observe_step({"kind": "step", "step": s, "ts": float(s),
                                 "n_ranks": n})
                for s, n in ((1, 4), (2, 3))], fh.verdict(now=2.0)
    events, verdict = both(case)
    assert [[e["to"] for e in ev] for ev in events] == [[], ["firing"]]
    assert verdict["status"] == "critical"


# ---------------------------------------------------- loading / overrides

NEW_RULE = {"name": "my_rule", "type": "threshold", "severity": "warn",
            "scope": "rank", "mode": "value",
            "metric": "mxtpu_serve_queue_depth", "labels": None,
            "op": ">", "bound": 3.0, "window_s": None, "summary": "mine",
            "for_s": 0.0, "resolve_for_s": 0.0}


@pytest.mark.parametrize("spec", [
    "fleet_skew.bound=0.25;serve_heartbeat.disable=1",
    json.dumps([{"name": "serve_error_rate", "bound": 0.5},
                {"name": "numerics_anomaly", "disable": True}, NEW_RULE]),
    json.dumps({"rules": [{"name": "io_bottleneck", "for_s": 3.0}]}),
    "{not json", "nosuchrule.bound=1", "serve_shed_burn.objective=2.0",
    "serve_queue_depth.for_s=-1"])
def test_load_rules_overrides(spec):
    rules = both(lambda tel, slo: slo.load_rules(spec=spec))
    by = {r["name"]: r for r in rules}
    defaults = {r["name"] for r in tslo.RULES}
    if spec.startswith("fleet_skew"):
        assert by["fleet_skew"]["bound"] == 0.25
        assert "serve_heartbeat" not in by
    elif spec.startswith("[{"):
        assert by["serve_error_rate"]["bound"] == 0.5
        assert "numerics_anomaly" not in by and by["my_rule"]["bound"] == 3
    elif "objective" in spec:
        assert set(by) == defaults - {"serve_shed_burn"}
    elif "for_s=-1" in spec:
        assert set(by) == defaults - {"serve_queue_depth"}
    elif "io_bottleneck" in spec:
        assert by["io_bottleneck"]["for_s"] == 3.0
    else:                                 # malformed: the defaults
        assert set(by) == defaults


def test_load_rules_from_file_and_env(tmp_path, monkeypatch):
    path = tmp_path / "rules.json"
    path.write_text(json.dumps([NEW_RULE]))
    monkeypatch.setenv("MXNET_TPU_SLO_RULES", "@%s" % path)
    monkeypatch.setenv("MXNET_TPU_SLO_FAST_S", "7")
    monkeypatch.setenv("MXNET_TPU_SLO_LATENCY_MS", "40")
    rules = both(lambda tel, slo: slo.load_rules())
    by = {r["name"]: r for r in rules}
    assert by["my_rule"]["window_s"] == 7.0
    assert by["serve_p99_latency_burn"]["threshold_s"] == 0.04
    assert both(lambda tel, slo: [r["name"] for r in slo.SloEngine().rules]
                ) == [r["name"] for r in rules if r["scope"] == "rank"]


# ------------------------------------------------------- engine emission

def test_engine_emits_alert_surface_metrics():
    def case(tel, slo):
        eng = _shed_engine(slo)
        req = tel.counter("mxtpu_serve_requests_total")
        eng.tick(now=0.0)
        req.labels(outcome="shed").inc(90)
        req.labels(outcome="ok").inc(10)
        eng.tick(now=5.0)
        return _state(tel, eng, 5.0)
    st = both(case)
    flat = st["metrics"]
    assert flat["mxtpu_health_status"] == 2.0
    assert flat['mxtpu_alert_state{rule="serve_shed_burn"}'] == 2.0
    assert flat['mxtpu_alerts_firing{severity="critical"}'] == 1.0
    assert flat['mxtpu_slo_burn_rate{rule="serve_shed_burn",'
                'window="fast"}'] == pytest.approx(90.0)
    assert flat['mxtpu_alert_transitions_total'
                '{rule="serve_shed_burn",to="firing"}'] == 1.0
    assert [e["to"] for e in st["flight"]] == ["firing"]


def test_every_rank_rule_through_one_storm(monkeypatch):
    """The whole default catalog on one engine, fed a serving storm and a
    stalled training loop, then a recovery: every transition equal."""
    monkeypatch.setenv("MXNET_TPU_PROCESS_ID", "3")

    def case(tel, slo):
        eng = slo.SloEngine()
        eng.configure("serve_queue_depth", bound=4.0, for_s=2.0)
        req = tel.counter("mxtpu_serve_requests_total")
        lat = tel.histogram("mxtpu_serve_request_seconds")
        rung = tel.counter("mxtpu_serve_rung_dispatch_total")
        depth = tel.gauge("mxtpu_serve_queue_depth")
        steps = tel.counter("mxtpu_step_total")
        step_s = tel.histogram("mxtpu_step_seconds")
        seg = tel.histogram("mxtpu_step_segment_seconds")
        anomalies = tel.counter("mxtpu_numerics_anomalies_total")
        io = tel.counter("mxtpu_io_bottleneck_total")
        seen = []
        for t in range(0, 400, 10):
            now = float(t)
            storm = 100 <= t < 200
            req.labels(outcome="ok").inc(20)
            req.labels(outcome="shed" if storm else "ok").inc(
                5 if storm else 1)
            if 150 <= t < 170:
                req.labels(outcome="error").inc(30)
            for _ in range(3):
                lat.labels(segment="total").observe(0.9 if storm else 0.01)
            if t < 250:
                rung.labels(rung="4").inc()
            depth.set(8.0 if storm else 1.0)
            if t < 120:
                steps.inc()
                step_s.observe(2.0 if t >= 80 else 0.5)
                seg.labels(segment="input_wait").observe(
                    0.4 if t >= 60 else 0.01)
            if t == 200:
                anomalies.labels(rule="nonfinite").inc()
                io.labels(stage="decode").inc()
                io.labels(stage="balanced").inc()
            eng.tick(now=now)
            seen.append(_state(tel, eng, now))
        return seen
    seen = both(case)
    fired = {e["rule"] for s in seen for e in s["flight"]
             if e["to"] == "firing"}
    assert {"serve_shed_burn", "serve_p99_latency_burn",
            "serve_error_rate", "serve_queue_depth", "train_heartbeat",
            "numerics_anomaly", "io_bottleneck"} <= fired
    assert seen[-1]["health"]["rank"] == 3


def test_health_doc_disabled_stub(monkeypatch):
    monkeypatch.setenv("MXNET_TPU_SLO", "0")
    doc = tslo.health()
    assert doc["status"] == "healthy" and doc["disabled"] is True
    jdoc = jslo.health()
    assert {k: v for k, v in doc.items() if k != "ts"} == \
        {k: v for k, v in jdoc.items() if k != "ts"}
    assert tslo.start_ticker() is None
    tslo.on_step()
    assert tslo._state["engine"] is None


def test_health_doc_shape():
    doc = both(lambda tel, slo: _shed_engine(slo).health(now=0.0))
    assert doc["schema"] == "mxtpu-health/1"
    assert set(doc) == {"schema", "ts", "rank", "status", "firing",
                        "pending", "resolved", "rules"}
    assert doc["rules"] == 1


def test_step_end_ticks_and_reset_drops_the_engine(monkeypatch):
    """``telemetry.step_end`` rides the engine's step cadence and
    ``telemetry.reset`` drops it, in both packages; the trainer's
    ``health()`` reads the verdict."""
    monkeypatch.setenv("MXNET_TPU_SLO_TICK_S", "0.05")

    def case(tel, slo):
        for _ in range(3):
            tel.step_end(samples=1, step_time=0.01)
        ticks = slo.engine()._ticks
        tel.reset()
        return ticks > 0, slo._state["engine"] is None
    assert both(case) == (True, True)
    from mxnet_tpu_torch.parallel import ShardedTrainer
    assert ShardedTrainer.health(None)["schema"] == "mxtpu-health/1"
