"""The serving tier's other half on the port, on the CPU: the cases of
``tests/test_trace_serving.py`` and the chaos and zero-compile cases of
``tests/test_serving.py`` run through the port's Batcher and Server; then
one request sequence through both packages' servers over the same tiny
net, whose ``mxtpu_serve_*`` families, label sets and counts in
``/metrics``, flight events, health verdicts and ``/alerts`` documents
must be equal, read by the JAX ``tools/serve_top.py``,
``tools/health_top.py --url`` and ``tools/trace_top.py``; the
``MXNET_TPU_SERVE_*`` defaults of the Batcher, the ladder and the Server
against the JAX package's; the ladder's CPU route and the op that a
failed capture names."""
import contextlib
import importlib.util
import io
import json
import os
import socket
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu import resilience as jres
from mxnet_tpu import serving as jserving
from mxnet_tpu import telemetry as jtel
from mxnet_tpu.telemetry import slo as jslo
from mxnet_tpu_torch import resilience as tres
from mxnet_tpu_torch import telemetry as ttel
from mxnet_tpu_torch.resilience import FaultInjected
from mxnet_tpu_torch.serving import (BatchLadder, Batcher, RequestShed,
                                     Server, ladder_rungs)
from mxnet_tpu_torch.telemetry import flight, tracing

slo = ttel.slo

from test_serving import FakeLadder, _rows

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = ("MXNET_TPU_TRACE_SAMPLE", "MXNET_TPU_TRACE_DIR",
       "MXNET_TPU_TRACE_RING", "MXNET_TPU_TRACE_SLOW_PCT",
       "MXNET_TPU_TELEMETRY_JSONL", "MXNET_TPU_FLIGHT_DIR", "MXNET_TPU_SLO",
       "MXNET_TPU_SLO_RULES", "MXNET_TPU_FAULTS", "MXNET_TPU_PROCESS_ID",
       "MXNET_TPU_SERVE_LADDER", "MXNET_TPU_SERVE_WINDOW_MS",
       "MXNET_TPU_SERVE_QUEUE_DEPTH", "MXNET_TPU_SERVE_DEADLINE_MS",
       "MXNET_TPU_SERVE_PORT")


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    for k in ENV:
        monkeypatch.delenv(k, raising=False)
    for pkg in (jtel, ttel):
        pkg.reset()
    for res in (jres, tres):
        res.clear_faults()
    yield
    for res in (jres, tres):
        res.clear_faults()
    for pkg in (jtel, ttel):
        pkg.reset()


def _get_doc(trace_id, tries=100):
    """Poll the ring: the submitter can see its reply a beat before the
    root trace finishes."""
    for _ in range(tries):
        doc = tracing.get_trace(trace_id)
        if doc is not None:
            return doc
        time.sleep(0.01)
    raise AssertionError("trace %s never landed in the ring" % trace_id)


def _load_tool(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "tools", "%s.py" % name))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ------------------------------------------------------------------ batcher

def test_batched_traces_share_one_linked_dispatch_span():
    lad = FakeLadder(rungs=(1, 4), wall=0.0005)
    bat = Batcher(lad, window_ms=200, queue_depth=16,
                  default_deadline_ms=5000)
    tids, errors = [None] * 3, []
    try:
        def go(i):
            try:
                with tracing.start_trace("client.%d" % i) as tr:
                    tids[i] = tr.trace_id
                    bat.submit(_rows(1, fill=float(i)))
            except Exception as e:  # collected and asserted below
                errors.append(e)

        threads = [threading.Thread(target=go, args=(i,)) for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30)
        assert not errors and lad.dispatches == [(4, 4)]
    finally:
        bat.close()
    docs = [_get_doc(t) for t in tids]
    disp_ids = set()
    for doc in docs:
        by_name = {s["name"]: s for s in doc["spans"]}
        root = doc["spans"][0]
        for name in ("serve.queue", "serve.coalesce", "serve.pad",
                     "serve.dispatch", "serve.slice"):
            assert by_name[name]["parent_id"] == root["span_id"]
        disp = by_name["serve.dispatch"]
        disp_ids.add(disp["span_id"])
        assert (disp["attrs"]["requests"], disp["attrs"]["rung"],
                disp["attrs"]["pad_rows"]) == (3, 4, 1)
        assert {(l["trace_id"], l["span_id"]) for l in disp["links"]} == \
            {(d["trace_id"], d["spans"][0]["span_id"]) for d in docs}
    assert len(disp_ids) == 1
    evs = [e for e in flight.events() if e["kind"] == "rung_dispatch"]
    assert [(e["rung"], e["rows"], e["requests"]) for e in evs] == \
        [(4, 3, 3)]
    assert evs[0]["trace_id"] in tids


def test_segment_walls_cover_submit_latency():
    lad = FakeLadder(rungs=(1, 4), wall=0.0005)
    real = lad.dispatch

    def slow_dispatch(rung, feed):
        time.sleep(0.05)
        return real(rung, feed)

    lad.dispatch = slow_dispatch
    bat = Batcher(lad, window_ms=1, queue_depth=16, default_deadline_ms=5000)
    try:
        t0 = time.monotonic()
        with tracing.start_trace("client.cov") as tr:
            bat.submit(_rows(1))
        wall = time.monotonic() - t0
    finally:
        bat.close()
    doc = _get_doc(tr.trace_id)
    segs = sum(s["dur_s"] for s in doc["spans"]
               if s["parent_id"] is not None)
    assert 0.05 <= segs <= wall * 1.05 and segs >= wall * 0.5
    assert tracing.dominant_segment(doc)[0] == "serve.dispatch"


def test_dispatch_error_records_error_span_before_failing():
    lad = FakeLadder(rungs=(1, 4))

    def boom(rung, feed):
        raise RuntimeError("kaboom")

    lad.dispatch = boom
    bat = Batcher(lad, window_ms=1, queue_depth=16, default_deadline_ms=5000)
    try:
        with pytest.raises(RuntimeError):
            with tracing.start_trace("client.err") as tr:
                bat.submit(_rows(1))
    finally:
        bat.close()
    doc = _get_doc(tr.trace_id)
    assert doc["status"] == "error"
    disp = [s for s in doc["spans"] if s["name"] == "serve.dispatch"][0]
    assert disp["status"] == "error" and "kaboom" in disp["attrs"]["error"]
    assert disp["links"][0]["trace_id"] == tr.trace_id
    assert ttel.REGISTRY.flat()[
        'mxtpu_serve_requests_total{outcome="error"}'] == 1.0


def test_untraced_submit_records_nothing():
    lad = FakeLadder(rungs=(1, 4))
    bat = Batcher(lad, window_ms=1, queue_depth=16, default_deadline_ms=5000)
    try:
        assert tracing.current() is None
        assert bat.submit(_rows(1))[0].shape == (1, 3)
    finally:
        bat.close()
    assert tracing.traces() == []


def test_explicit_zero_deadline_sheds_not_defaults():
    lad = FakeLadder(rungs=(1, 4))
    bat = Batcher(lad, window_ms=1, queue_depth=16, default_deadline_ms=5000)
    try:
        for ddl in (0, 0.0, -5):
            with pytest.raises(RequestShed) as ei:
                bat.submit(_rows(1), deadline_ms=ddl)
            assert ei.value.reason == "deadline"
            assert ei.value.rid is not None
            assert "expired on arrival" in str(ei.value)
        assert lad.dispatches == []
        assert bat.submit(_rows(1), deadline_ms=None)[0].shape == (1, 3)
    finally:
        bat.close()
    flat = ttel.REGISTRY.flat()
    assert flat['mxtpu_serve_shed_total{reason="deadline"}'] == 3.0
    assert flat['mxtpu_serve_requests_total{outcome="shed"}'] == 3.0


def test_shed_exception_carries_rid_and_marks_trace():
    lad = FakeLadder(rungs=(1, 4))
    bat = Batcher(lad, window_ms=1, queue_depth=16, default_deadline_ms=5000)
    try:
        with tracing.start_trace("client.shed") as tr:
            with pytest.raises(RequestShed) as ei:
                bat.submit(_rows(1), deadline_ms=0)
        rid = ei.value.rid
    finally:
        bat.close()
    doc = _get_doc(tr.trace_id)
    assert (doc["status"], doc["keep"]) == ("shed", "shed")
    assert doc["attrs"]["shed_reason"] == "deadline"
    assert doc["attrs"]["rid"] == rid
    evs = [e for e in flight.events() if e["kind"] == "request_shed"]
    assert evs[-1]["rid"] == rid and evs[-1]["trace_id"] == tr.trace_id
    assert ("rid %d:" % rid) in evs[-1]["detail"]


def test_queue_full_shed_counts_and_depth_gauge():
    gate, entered = threading.Event(), threading.Event()
    lad = FakeLadder(rungs=(1,))
    real = lad.dispatch

    def gated(rung, feed):
        entered.set()
        assert gate.wait(30)
        return real(rung, feed)

    lad.dispatch = gated
    bat = Batcher(lad, window_ms=1, queue_depth=2, default_deadline_ms=10000)
    oks = []
    try:
        first = threading.Thread(
            target=lambda: oks.append(bat.submit(_rows(1), timeout=30)))
        first.start()
        assert entered.wait(10)
        queued = [threading.Thread(
            target=lambda: oks.append(bat.submit(_rows(1), timeout=30)))
            for _ in range(2)]
        for t in queued:
            t.start()
        deadline = time.monotonic() + 10
        while bat.queue_depth() < 2 and time.monotonic() < deadline:
            time.sleep(0.005)
        assert ttel.REGISTRY.flat()["mxtpu_serve_queue_depth"] == 2.0
        with pytest.raises(RequestShed) as ei:
            bat.submit(_rows(1))
        assert ei.value.reason == "queue_full"
        gate.set()
        for t in [first] + queued:
            t.join(30)
        assert len(oks) == 3
    finally:
        gate.set()
        bat.close()
    flat = ttel.REGISTRY.flat()
    assert flat['mxtpu_serve_shed_total{reason="queue_full"}'] == 1.0
    assert flat['mxtpu_serve_requests_total{outcome="ok"}'] == 3.0
    assert flat['mxtpu_serve_rung_dispatch_total{rung="1"}'] == 3.0
    assert flat['mxtpu_serve_rung_occupancy_count{rung="1"}'] == 3.0
    assert flat["mxtpu_serve_queue_depth"] == 0.0
    assert [e["reason"] for e in flight.events()
            if e["kind"] == "request_shed"] == ["queue_full"]


def test_chaos_fault_fails_batch_fast_without_wedging_queue():
    lad = FakeLadder(rungs=(1, 4))
    bat = Batcher(lad, window_ms=1, queue_depth=8, default_deadline_ms=5000)
    try:
        tres.configure_faults("serve.dispatch:n=1")
        t0 = time.monotonic()
        with pytest.raises(FaultInjected):
            bat.submit(_rows(1))
        assert time.monotonic() - t0 < 2.0
        assert bat.submit(_rows(1))[0].shape == (1, 3)
        assert bat.alive and lad.dispatches == [(1, 1)]
    finally:
        bat.close()
    kinds = [(e["kind"], e.get("error", "")[:8]) for e in flight.events()
             if e["kind"] in ("fault", "rung_dispatch")]
    assert kinds == [("fault", ""), ("rung_dispatch", "injected"),
                     ("rung_dispatch", "")]


# ------------------------------------------------------------- front door

class _Ladder(FakeLadder):
    """The fake ladder with the ``describe`` that ``/healthz`` reads."""

    def describe(self):
        return {"rungs": list(self.rungs)}


@pytest.fixture()
def _server():
    lad = _Ladder(rungs=(1, 4), wall=0.0005)
    srv = Server(lad, batcher=Batcher(lad, window_ms=1, queue_depth=16,
                                      default_deadline_ms=5000),
                 port=0, host="127.0.0.1").start()
    try:
        yield srv
    finally:
        srv.close()


def _post(port, doc, headers=None):
    req = urllib.request.Request(
        "http://127.0.0.1:%d/predict" % port, data=json.dumps(doc).encode(),
        method="POST", headers=dict({"Content-Type": "application/json"},
                                    **(headers or {})))
    return urllib.request.urlopen(req, timeout=30)


def _get(port, path):
    try:
        with urllib.request.urlopen("http://127.0.0.1:%d%s" % (port, path),
                                    timeout=30) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def test_predict_reply_names_its_trace(_server):
    with _post(_server.port, {"data": [[1.0, 2.0, 3.0]]}) as resp:
        body = json.loads(resp.read())
        tid = resp.headers["X-Trace-Id"]
        tp = resp.headers["traceparent"]
    assert body["rows"] == 1 and len(tid) == 32
    assert tracing.parse_traceparent(tp)[0] == tid
    doc = _get_doc(tid)
    assert doc["root"] == "serve.request" and doc["attrs"]["rows"] == 1
    names = {s["name"] for s in doc["spans"]}
    assert "serve.dispatch" in names and "serve.queue" in names


def test_predict_continues_inbound_traceparent(_server):
    tid, parent_sid = "ab" * 16, "cd" * 8
    with _post(_server.port, {"data": [[0.0, 0.0, 0.0]]},
               headers={"traceparent": "00-%s-%s-01" % (tid, parent_sid)}
               ) as resp:
        assert resp.headers["X-Trace-Id"] == tid
    assert _get_doc(tid)["spans"][0]["parent_id"] == parent_sid


def test_predict_shed_503_carries_rid_and_trace_id(_server):
    with pytest.raises(urllib.error.HTTPError) as ei:
        _post(_server.port, {"data": [[1.0, 2.0, 3.0]], "deadline_ms": 0})
    assert ei.value.code == 503
    body = json.loads(ei.value.read())
    assert body["shed"] == "deadline" and isinstance(body["rid"], int)
    assert len(body["trace_id"]) == 32
    assert ei.value.headers["X-Trace-Id"] == body["trace_id"]
    assert _get_doc(body["trace_id"])["status"] == "shed"


def test_predict_traced_exemplar_resolves(_server):
    for _ in range(3):
        with _post(_server.port, {"data": [[1.0, 1.0, 1.0]]}) as resp:
            tid = resp.headers["X-Trace-Id"]
    ex = tracing.exemplar_for("mxtpu_serve_request_seconds",
                              {"segment": "total"})
    assert ex is not None and len(ex) == 32 and tid
    assert _get_doc(ex)["root"] == "serve.request"
    status, text = _get(_server.port, "/metrics")
    assert status == 200 and b' # {trace_id="' in text


def test_predict_disabled_tracing_no_headers(monkeypatch, _server):
    monkeypatch.setenv("MXNET_TPU_TRACE_SAMPLE", "0")
    with _post(_server.port, {"data": [[1.0, 2.0, 3.0]]}) as resp:
        assert json.loads(resp.read())["rows"] == 1
        assert resp.headers.get("X-Trace-Id") is None
        assert resp.headers.get("traceparent") is None
    assert tracing.traces() == []


def test_healthz_deep_embeds_verdict_and_drains_on_critical(_server):
    status, body = _get(_server.port, "/healthz?deep=1")
    doc = json.loads(body)
    assert status == 200 and doc["health"]["schema"] == "mxtpu-health/1"
    assert doc["status"] == doc["health"]["status"] == "healthy"
    eng = slo.engine()
    assert next(r for r in eng.rules if r["name"] == "serve_queue_depth")[
        "bound"] == pytest.approx(0.9 * 16)
    # a burning shed budget is critical: the replica asks to be drained
    eng.tick()
    ttel.counter("mxtpu_serve_requests_total").labels(
        outcome="shed").inc(50)
    eng.tick()
    status, body = _get(_server.port, "/healthz?deep=1")
    assert status == 503 and json.loads(body)["status"] == "critical"
    status, body = _get(_server.port, "/healthz")
    assert status == 200 and "health" not in json.loads(body)
    status, body = _get(_server.port, "/alerts")
    alerts = json.loads(body)
    assert status == 200 and alerts["status"] == "critical"
    assert {a["rule"] for a in alerts["alerts"]} == {
        r["name"] for r in eng.rules}


def test_server_arms_the_ticker_unless_slo_is_off(monkeypatch):
    lad = FakeLadder(rungs=(1,))
    srv = Server(lad, batcher=Batcher(lad, window_ms=1), port=0,
                 host="127.0.0.1")
    try:
        assert slo._state["ticker"] is not None
        assert slo._state["ticker"].is_alive()
    finally:
        srv.close()
    ttel.reset()
    monkeypatch.setenv("MXNET_TPU_SLO", "0")
    srv = Server(lad, batcher=Batcher(lad, window_ms=1), port=0,
                 host="127.0.0.1").start()
    try:
        assert slo._state["ticker"] is None
        status, body = _get(srv.port, "/alerts")
        assert json.loads(body)["disabled"] is True
        assert json.loads(body)["alerts"] == []
    finally:
        srv.close()


# ---------------------------------------------- the ladder on a real net

def _weights(features=6, hidden=5):
    rng = np.random.RandomState(7)
    return {"fc_weight": rng.uniform(-0.5, 0.5, (hidden, features))
            .astype(np.float32),
            "fc_bias": rng.uniform(-0.1, 0.1, hidden).astype(np.float32)}


def _tiny_predictor(mx, batch=1, features=6, **kw):
    data = mx.sym.Variable("data")
    fc = mx.sym.FullyConnected(data, num_hidden=5, name="fc")
    net = mx.sym.SoftmaxOutput(fc, name="softmax")
    params = {k: mx.nd.array(v, **kw) for k, v in _weights().items()}
    return mx.predictor.Predictor(net.tojson(), params,
                                  {"data": (batch, features)}, **kw)


def test_ladder_zero_compiles_after_warmup():
    ladder = BatchLadder(_tiny_predictor(tmx, ctx=tmx.cpu()),
                         rungs=(1, 2, 4))
    assert not ladder.graphs and ladder.describe()["graphs"] == []
    assert ladder.describe()["cost_model_ms"] == {}
    counter = ttel.counter("mxtpu_compile_total")
    before = counter.get()
    bat = Batcher(ladder, window_ms=1, queue_depth=8,
                  default_deadline_ms=5000)
    try:
        for rows in (1, 2, 3, 4, 1, 3):
            out = bat.submit(_rows(rows, tail=(6,)))
            assert out[0].shape == (rows, 5)
    finally:
        bat.close()
    assert counter.get() == before
    assert bat.dispatch_counts() == {1: 2, 2: 1, 4: 3}


def test_ladder_annotates_the_dispatch_span():
    ladder = BatchLadder(_tiny_predictor(tmx, ctx=tmx.cpu()), rungs=(1, 4),
                         budget_check=False)
    bat = Batcher(ladder, window_ms=1, default_deadline_ms=5000)
    try:
        with tracing.start_trace("client") as tr:
            bat.submit(_rows(3, tail=(6,)))
    finally:
        bat.close()
    disp = [s for s in _get_doc(tr.trace_id)["spans"]
            if s["name"] == "serve.dispatch"][0]["attrs"]
    assert (disp["ladder_rung"], disp["ladder_pad_rows"],
            disp["ladder_slice_outputs"]) == (4, 0, 1)


@pytest.mark.parametrize("budget_check", [True, False])
def test_ladder_says_its_budget_gate_is_not_applied(caplog, budget_check):
    """``budget_check`` is the JAX argument; until memlive is ported the
    ladder checks nothing, and says so when asked to check."""
    with caplog.at_level("WARNING", logger="mxnet_tpu_torch.serving.ladder"):
        BatchLadder(_tiny_predictor(tmx, ctx=tmx.cpu()), rungs=(1,),
                    budget_check=budget_check)
    said = [r for r in caplog.records if "budget_check" in r.getMessage()]
    assert len(said) == (1 if budget_check else 0)


def test_failed_op_is_named():
    """A failed capture names the op: ``eval_graph`` notes the node an
    error came from, and the ladder reads the note back along the
    context chain."""
    import torch
    from mxnet_tpu_torch.serving.ladder import _failed_op
    data = tmx.sym.Variable("data")
    net = tmx.sym.FullyConnected(data, num_hidden=4, name="fc")
    exe = net.simple_bind(tmx.cpu(), data=(2, 3))
    exe.arg_dict["data"]._data = torch.zeros(2, 5)   # what a rebind breaks
    with pytest.raises(RuntimeError) as ei:
        exe.forward(is_train=False)
    assert _failed_op(ei.value) == "op FullyConnected (node 'fc')"
    try:
        try:
            raise ei.value
        except Exception:
            raise RuntimeError("capture invalidated")
    except RuntimeError as outer:
        assert _failed_op(outer) == "op FullyConnected (node 'fc')"
    assert _failed_op(RuntimeError("no note")) is None


# ------------------------------------- both packages, one request sequence

SEQUENCE = ({"rows": 1}, {"rows": 3}, {"rows": 2}, {"rows": 1,
            "deadline_ms": 0}, {"rows": 1, "fault": True}, {"rows": 4},
            {"rows": 1})


def _drive(mx, tel, res, slo_mod, serving, tmp_path, name, monkeypatch):
    """SEQUENCE through one package's Server over the tiny net, one
    request at a time; returns what the readers see."""
    kw = {"ctx": tmx.cpu()} if mx is tmx else {}
    monkeypatch.setenv("MXNET_TPU_TRACE_DIR", str(tmp_path / name))
    ladder = serving.BatchLadder(_tiny_predictor(mx, **kw), rungs=(1, 4))
    bat = serving.Batcher(ladder, window_ms=1, queue_depth=8,
                          default_deadline_ms=5000)
    extra = {"host": "127.0.0.1"} if mx is tmx else {}
    srv = serving.Server(ladder, batcher=bat, port=0, **extra).start()
    rng = np.random.RandomState(3)
    replies = []
    slo_mod.engine().tick()             # the windows' first sample
    try:
        for req in SEQUENCE:
            body = {"data": rng.uniform(-1, 1, (req["rows"], 6)).tolist()}
            if "deadline_ms" in req:
                body["deadline_ms"] = req["deadline_ms"]
            if req.get("fault"):
                res.configure_faults("serve.dispatch:n=1")
            try:
                with _post(srv.port, body) as r:
                    out = json.loads(r.read())
                    replies.append((r.status, np.asarray(out["outputs"][0])))
            except urllib.error.HTTPError as e:
                replies.append((e.code, sorted(json.loads(e.read()))))
            res.clear_faults()
        slo_mod.engine().tick()
        status, metrics = _get(srv.port, "/metrics")
        deep = _get(srv.port, "/healthz?deep=1")
        ht = _load_tool("health_top")
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            ht_rc = ht.main(["--url", "http://127.0.0.1:%d" % srv.port,
                             "--json"])
        health_top = json.loads(buf.getvalue())
    finally:
        srv.close()
        slo_mod.stop_ticker()
    # the fault's message words its arming note apart: compare the site
    flights = [{k: v.split(")")[0] if k == "error" else v
                for k, v in e.items()
                if k not in ("ts", "seq", "wall_ms", "waited_ms",
                             "trace_id")}
               for e in tel.flight.events()
               if e["kind"] in ("rung_dispatch", "request_shed", "fault")]
    return {"replies": replies, "metrics": metrics.decode(),
            "deep": (deep[0], json.loads(deep[1])["health"]),
            "health_top": (ht_rc, health_top), "flight": flights,
            "dispatches": bat.dispatch_counts() if mx is tmx else None}


def _families(text):
    """(counter/gauge samples, histogram sample keys, histogram counts)
    of the mxtpu_serve_* families."""
    values, keys, counts = {}, set(), {}
    for line in text.splitlines():
        if not line.startswith("mxtpu_serve_"):
            continue
        key = line.split(" # ")[0].rsplit(" ", 1)[0]
        val = float(line.split(" # ")[0].rsplit(" ", 1)[1])
        name = key.split("{")[0]
        if name.endswith(("_bucket", "_sum", "_count")) and \
                name.rsplit("_", 1)[0] in ("mxtpu_serve_request_seconds",
                                           "mxtpu_serve_rung_occupancy"):
            keys.add(key)
            if name.endswith("_count") or "occupancy" in name:
                counts[key] = val
        else:
            values[key] = val
    return values, keys, counts


def _strip_times(doc):
    drop = ("ts", "since_s", "ago_s", "value", "burn_fast", "burn_slow",
            "exemplar_trace")
    if isinstance(doc, dict):
        return {k: _strip_times(v) for k, v in doc.items() if k not in drop}
    if isinstance(doc, (list, tuple)):
        return [_strip_times(v) for v in doc]
    return doc


def test_same_requests_same_metrics_and_readers(tmp_path, monkeypatch):
    jout = _drive(jmx, jtel, jres, jslo, jserving, tmp_path, "jax",
                  monkeypatch)
    tout = _drive(tmx, ttel, tres, slo, __import__(
        "mxnet_tpu_torch.serving", fromlist=["x"]), tmp_path, "torch",
        monkeypatch)
    # the answers, the refusals and the failure
    assert [r[0] for r in tout["replies"]] == [r[0] for r in jout["replies"]]\
        == [200, 200, 200, 503, 500, 200, 200]
    for (st, tr), (_sj, jr) in zip(tout["replies"], jout["replies"]):
        if st == 200:
            np.testing.assert_allclose(tr, jr, rtol=1e-5, atol=1e-6)
        else:
            assert tr == jr
    # /metrics: the families, their label sets and the counts
    tv, tk, tc = _families(tout["metrics"])
    jv, jk, jc = _families(jout["metrics"])
    assert tv == jv and tk == jk and tc == jc
    assert tv['mxtpu_serve_requests_total{outcome="ok"}'] == 5.0
    assert tv['mxtpu_serve_requests_total{outcome="shed"}'] == 1.0
    assert tv['mxtpu_serve_requests_total{outcome="error"}'] == 1.0
    assert tv['mxtpu_serve_shed_total{reason="deadline"}'] == 1.0
    assert tv['mxtpu_serve_rung_dispatch_total{rung="4"}'] == 3.0
    assert tout["dispatches"] == {1: 2, 4: 3}
    # serve_top reads both alike
    st = _load_tool("serve_top")
    tdoc, jdoc = (st.summarize(st.parse_prom(o["metrics"]))
                  for o in (tout, jout))
    for doc in (tdoc, jdoc):
        doc.pop("latency_ms")
    assert tdoc == jdoc
    assert tdoc["hot_rung"] == "4" and tdoc["dominant_shed_reason"] == \
        "deadline"
    assert tdoc["health"] == "critical"        # the shed budget burns
    # the verdicts, /alerts through health_top, the flight events
    assert _strip_times(tout["deep"]) == _strip_times(jout["deep"])
    assert tout["deep"][0] == 503
    assert tout["health_top"][0] == jout["health_top"][0] == 1
    assert _strip_times(tout["health_top"][1]) == \
        _strip_times(jout["health_top"][1])
    assert tout["flight"] == jout["flight"]
    # trace_top reads the port's trace files as the JAX package's
    tt = _load_tool("trace_top")
    tops = {}
    for name in ("jax", "torch"):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert tt.main([str(tmp_path / name), "--json"]) == 0
        tops[name] = json.loads(buf.getvalue())
    assert tops["torch"]["traces"] == tops["jax"]["traces"] == \
        len(SEQUENCE)
    rows = {n: sorted((r["status"], r["root"]) for r in tops[n]["rows"])
            for n in tops}
    assert rows["torch"] == rows["jax"]
    assert set(tops["torch"]["critical_path"]["segments_ms"]) == \
        set(tops["jax"]["critical_path"]["segments_ms"])


# ------------------------------------------------------ MXNET_TPU_SERVE_*

def test_batcher_reads_the_serve_env(monkeypatch):
    monkeypatch.setenv("MXNET_TPU_SERVE_WINDOW_MS", "17")
    monkeypatch.setenv("MXNET_TPU_SERVE_QUEUE_DEPTH", "3")
    monkeypatch.setenv("MXNET_TPU_SERVE_DEADLINE_MS", "250")
    lad = FakeLadder()
    tb = Batcher(lad, start=False)
    jb = jserving.Batcher(lad, start=False)
    assert (tb._window, tb._depth, tb._deadline) == \
        (jb._window, jb._depth, jb._deadline) == (0.017, 3, 0.25)
    tb.close()


def test_ladder_rungs_read_the_serve_env(monkeypatch):
    assert ladder_rungs(None) == jserving.ladder_rungs(None) == (1, 4, 16,
                                                                 64)
    monkeypatch.setenv("MXNET_TPU_SERVE_LADDER", "8,2;2")
    assert ladder_rungs(None) == jserving.ladder_rungs(None) == (2, 8)
    assert BatchLadder(_tiny_predictor(tmx, ctx=tmx.cpu())).rungs == (2, 8)
    monkeypatch.setenv("MXNET_TPU_SERVE_LADDER", "x")
    with pytest.raises(tmx.MXNetError, match="MXNET_TPU_SERVE_LADDER"):
        ladder_rungs(None)


def test_server_port_reads_the_serve_env_and_rank(monkeypatch):
    from mxnet_tpu.serving.server import serve_port as jserve_port
    from mxnet_tpu_torch.serving import serve_port
    for env, port, want in (({}, None, 8080),
                            ({"MXNET_TPU_SERVE_PORT": "9000"}, None, 9000),
                            ({"MXNET_TPU_SERVE_PORT": "9000",
                              "MXNET_TPU_PROCESS_ID": "3"}, None, 9003),
                            ({"MXNET_TPU_PROCESS_ID": "2"}, 7000, 7002),
                            ({"MXNET_TPU_PROCESS_ID": "2"}, 0, 0),
                            ({"MXNET_TPU_SERVE_PORT": "nope"}, None, 8080)):
        for k in ("MXNET_TPU_SERVE_PORT", "MXNET_TPU_PROCESS_ID"):
            monkeypatch.delenv(k, raising=False)
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        assert serve_port(port) == jserve_port(port) == want
    # the Server binds it: a free base port, rank 1
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        free = s.getsockname()[1]
    monkeypatch.setenv("MXNET_TPU_SERVE_PORT", str(free - 1))
    monkeypatch.setenv("MXNET_TPU_PROCESS_ID", "1")
    lad = FakeLadder()
    srv = Server(lad, batcher=Batcher(lad, start=False), host="127.0.0.1")
    try:
        assert srv.port == free
    finally:
        srv.close()


def test_config_serve_and_slo_variables_are_honored():
    cat = tmx.config.describe()
    for name in ("MXNET_TPU_SERVE_LADDER", "MXNET_TPU_SERVE_WINDOW_MS",
                 "MXNET_TPU_SERVE_QUEUE_DEPTH", "MXNET_TPU_SERVE_DEADLINE_MS",
                 "MXNET_TPU_SERVE_PORT", "MXNET_TPU_SLO",
                 "MXNET_TPU_SLO_RULES", "MXNET_TPU_SLO_TICK_S",
                 "MXNET_TPU_SLO_FAST_S", "MXNET_TPU_SLO_SLOW_S",
                 "MXNET_TPU_SLO_LATENCY_MS"):
        assert cat[name][1] == "honored", name
        assert cat[name][0] == jmx.config.describe()[name][0], name
    assert cat["MXNET_TPU_SERVE_COST_MODEL"][1] == "inert"
