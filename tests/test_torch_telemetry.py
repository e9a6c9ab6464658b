"""The port's telemetry core against the JAX package's, on the CPU: the
same catalog, Prometheus text, report, ioview verdicts and summaries,
tracing decisions and numerics statistics from the same inputs; the
profiler's Chrome trace; flight dumps, OOM annotation and the memory
gauges; the modules named but not ported; the config catalog's honored
variables."""
import json
import os

import numpy as np
import pytest

import torch_threads  # noqa: F401  (xdist workers share the cores)

import mxnet_tpu as mx
import mxnet_tpu_torch as tmx
from mxnet_tpu import telemetry as jtel
from mxnet_tpu_torch import telemetry as ttel

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = ("MXNET_TPU_TELEMETRY_JSONL", "MXNET_TPU_FLIGHT_DIR",
       "MXNET_TPU_TRACE_DIR", "MXNET_TPU_TRACE_SAMPLE",
       "MXNET_TPU_IOVIEW_EVERY", "MXNET_TPU_IOVIEW_WINDOW",
       "MXNET_TPU_NUMERICS_EVERY", "MXNET_TPU_NUMERICS_LEDGER",
       "MXNET_PROFILER_XLA_DIR", "MXNET_TPU_MEMORY_BUDGET")


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    for k in ENV:
        monkeypatch.delenv(k, raising=False)
    jtel.reset()
    ttel.reset()
    yield
    jtel.reset()
    ttel.reset()


def test_catalog_is_the_jax_catalog():
    assert ttel.CATALOG == jtel.CATALOG
    assert set(ttel.NOT_EMITTED) < set(ttel.CATALOG)
    assert all(isinstance(v, str) and v for v in ttel.NOT_EMITTED.values())
    # the serving tier and the SLO engine set every one of theirs
    assert not [n for n in ttel.NOT_EMITTED
                if n.startswith(("mxtpu_serve_", "mxtpu_alert",
                                 "mxtpu_slo_", "mxtpu_health_"))]
    assert ttel.selfcheck() == [] == jtel.selfcheck()
    with pytest.raises(tmx.MXNetError, match="not declared"):
        ttel.counter("mxtpu_no_such_total")


def _emit(tel):
    tel.counter("mxtpu_io_records_total").labels(source="recordio").inc(5)
    tel.counter("mxtpu_io_records_total").labels(source="native").inc(3)
    tel.counter("mxtpu_retry_total").labels(site='a"b\\c').inc()
    tel.gauge("mxtpu_hbm_bytes_in_use").labels(device="cuda:0").set(123)
    tel.gauge("mxtpu_hbm_peak_bytes").labels(device="cuda:0").set(2.5)
    for v in (0.0003, 0.02, 0.3, 7.0, 30.0):
        tel.histogram("mxtpu_step_seconds").observe(v)
        tel.histogram("mxtpu_span_seconds").labels(span="fwd").observe(v / 2)
    tel.histogram("mxtpu_io_queue_occupancy",
                  buckets=(0.0, 1.0, 2.0, 4.0, 8.0, 16.0, 32.0)).labels(
        iter="device").observe(2, weight=0.25)


def test_render_prom_equals_jax_after_the_same_emits():
    _emit(jtel)
    _emit(ttel)
    text = ttel.render_prom()
    assert text == jtel.render_prom()
    assert 'mxtpu_step_seconds_bucket{le="+Inf"} 5' in text
    assert ttel.REGISTRY.flat() == jtel.REGISTRY.flat()


def test_report_percentiles_equal_jax_from_the_same_step_times():
    times = [0.5, 0.12, 0.1, 0.11, 0.13, 0.09, 0.1, 0.4]
    for tel in (jtel, ttel):
        for t in times:
            with tel.span("trainer.step"):
                pass
            tel.step_end(samples=32, step_time=t)
    rj, rt = jtel.report(), ttel.report()
    assert set(rt) == set(rj)
    assert rt["steps"] == rj["steps"] == len(times)
    assert rt["step_time_s"] == rj["step_time_s"]
    assert rt["throughput"]["samples_per_sec"] == \
        rj["throughput"]["samples_per_sec"]
    assert set(rt["phases"]) == set(rj["phases"]) == {"trainer.step"}
    assert rt["compile"]["source"] == "nvcc"
    assert rt["memory"] == {"plans": {}, "live": None}
    ttel.reset_steps()
    assert ttel.report()["steps"] == 0


def _drive_ioview(iov, clock):
    iov._now = lambda: clock[0]
    tracker = iov.queue_tracker("device")
    for i in range(6):
        clock[0] += 0.1
        iov.account("read", 0.001, items=1, nbytes=1000)
        iov.account("decode", 0.03 if i % 2 else 0.05, items=4,
                    nbytes=4 * 3072)
        iov.account("batch", 0.002, items=4)
        iov.account("device_stage", 0.004, items=1, nbytes=12288)
        tracker.adjust(+1)
        clock[0] += 0.05
        iov.note_stall("device", 0.04)
        iov.note_starved("device", 0.001)
        tracker.adjust(-1)
    clock[0] += 0.5


@pytest.mark.parametrize("stall", [0.04, 0.0])
def test_ioview_verdicts_and_summary_equal_jax(monkeypatch, stall):
    monkeypatch.setenv("MXNET_TPU_IOVIEW_WINDOW", "0.5")
    out = []
    for iov in (jtel.ioview, ttel.ioview):
        clock = [100.0]
        monkeypatch.setattr(iov, "_now", lambda c=clock: c[0])
        if not stall:
            monkeypatch.setattr(iov, "note_stall", lambda *a: None)
        _drive_ioview(iov, clock)
        rec = iov.step_record()
        verdict = iov.classify(force=True)
        out.append((rec, verdict, iov.summary(), iov.snapshot()))
    assert out[0] == out[1]
    assert out[1][1]["verdict"] in ("producer-bound", "consumer-bound",
                                    "balanced")
    if stall:
        assert out[1][1]["verdict"] == "producer-bound"
        assert out[1][1]["stage"] == "decode"
    records = [{"rank": 0, "io": out[1][0]}]
    assert ttel.ioview.summarize_io(records) == \
        jtel.ioview.summarize_io(records)


def test_tracing_keeps_the_same_traces_from_the_same_ids(monkeypatch):
    monkeypatch.setenv("MXNET_TPU_TRACE_SAMPLE", "0.3")
    rng = np.random.RandomState(0)
    ids = ["%032x" % int(v) for v in rng.randint(0, 2 ** 62, 40)]
    durs = rng.exponential(0.1, 40)
    kept = []
    for tr in (jtel.tracing, ttel.tracing):
        for i, (tid, d) in enumerate(zip(ids, durs)):
            tr._finish({"trace_id": tid, "root": "trainer.step", "rank": 0,
                        "ts": 1.0 + i, "status": "error" if i == 7
                        else "ok", "attrs": {}, "spans": [],
                        "dur_s": round(float(d), 6)})
        kept.append([(t["trace_id"], t["keep"]) for t in tr.traces()])
    assert kept[0] == kept[1]
    assert {k for _t, k in kept[1]} >= {"sampled", "error"}
    for h in ("00-%s-%s-01" % (ids[0], "ab" * 8), "garbage",
              "00-" + "0" * 32 + "-" + "ab" * 8 + "-01"):
        assert ttel.tracing.parse_traceparent(h) == \
            jtel.tracing.parse_traceparent(h)


def test_trace_export_is_the_jax_schema(tmp_path, monkeypatch):
    monkeypatch.setenv("MXNET_TPU_TRACE_DIR", str(tmp_path))
    with ttel.tracing.start_trace("trainer.step", attrs={"step": 1}):
        with ttel.span("inner"):
            pass
    docs = jtel.tracing.read_traces(str(tmp_path))
    assert len(docs) == 1 and docs[0]["root"] == "trainer.step"
    assert [s["name"] for s in docs[0]["spans"]] == ["trainer.step",
                                                     "inner"]


def test_numerics_step_stats_equal_jax():
    import jax.numpy as jnp
    import torch
    rng = np.random.RandomState(1)
    params = {"w": rng.randn(16, 8).astype(np.float32),
              "b": np.zeros(8, np.float32)}
    grads = {"w": rng.randn(16, 8).astype(np.float32),
             "b": np.array([1, 0, np.nan, 0, 2, 0, np.inf, 0], np.float32)}
    js = jtel.numerics.step_stats({k: jnp.asarray(v)
                                   for k, v in params.items()},
                                  {k: jnp.asarray(v)
                                   for k, v in grads.items()}, loss=1.5)
    ts = ttel.numerics.step_stats({k: torch.from_numpy(v)
                                   for k, v in params.items()},
                                  {k: torch.from_numpy(v)
                                   for k, v in grads.items()}, loss=1.5)
    jp = jtel.numerics._host_payload(js, 3, "trainer.step")
    tp = ttel.numerics._host_payload(ts, 3, "trainer.step")
    assert set(jp["tensors"]) == set(tp["tensors"])
    for name, st in jp["tensors"].items():
        for k, v in st.items():
            assert tp["tensors"][name][k] == pytest.approx(v, abs=1e-6), \
                (name, k)
        assert tp["tensors"][name]["digest"] == st["digest"]
    assert tp["digest"] == jp["digest"]
    assert tp["grad_norm"] == pytest.approx(jp["grad_norm"], rel=1e-6)
    anomalies = ttel.numerics._check_rules(tp)
    assert [a["rule"] for a in anomalies] == \
        [a["rule"] for a in jtel.numerics._check_rules(jp)]


def test_flight_dump_reads_with_the_jax_reader(tmp_path, monkeypatch,
                                                capsys):
    import importlib.util
    monkeypatch.setenv("MXNET_TPU_FLIGHT_DIR", str(tmp_path))
    ttel.flight.record("step_begin", program="trainer.step", step=1)
    with pytest.raises(tmx.MXNetError):
        with ttel.flight.crash_guard("trainer.step"):
            raise tmx.MXNetError("boom")
    dumps = sorted(p for p in os.listdir(tmp_path) if p.endswith(".json"))
    assert len(dumps) == 1 and "error" in dumps[0]
    spec = importlib.util.spec_from_file_location(
        "flight_read", os.path.join(ROOT, "tools", "flight_read.py"))
    fr = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(fr)
    assert fr.main([os.path.join(tmp_path, dumps[0])]) == 0
    out = capsys.readouterr().out
    assert "step_begin" in out and "boom" in out
    assert fr.main([str(tmp_path), "--json"]) == 0


def test_flight_ring_is_bounded_and_lock_free():
    rec = ttel.flight.FlightRecorder(capacity_=8)
    seqs = [rec.record("x", i=i) for i in range(20)]
    assert seqs == list(range(1, 21))
    assert [e["i"] for e in rec.events()] == list(range(12, 20))
    assert not hasattr(rec, "_lock")


def test_annotate_oom_and_memory_without_a_card(monkeypatch):
    import torch
    with pytest.raises(ttel.memory.HbmOomError, match="out of memory"):
        with ttel.memory.annotate_oom("trainer.step"):
            raise torch.cuda.OutOfMemoryError("CUDA out of memory.")
    assert ttel.counter("mxtpu_oom_total").labels(
        program="trainer.step").get() == 1
    with pytest.raises(ValueError):
        with ttel.memory.annotate_oom("trainer.step"):
            raise ValueError("not an OOM")
    assert not ttel.memory.is_oom_error(MemoryError())
    assert ttel.memory.sample_live_memory() is None
    assert ttel.memory.device_memory_stats() is None
    assert ttel.memory.plan_of(object(), "p") is None
    fn = object()
    assert ttel.memory.planned_executable("p", fn, ()) is fn
    monkeypatch.setenv("MXNET_TPU_HBM_LIMIT_BYTES", "1000")
    plan = ttel.memory.MemoryPlan("p", memory={"argument": 600,
                                               "temp": 600})
    with pytest.raises(tmx.MXNetError, match="budget"):
        ttel.memory.check_budget(plan)
    ttel.memory.check_budget(None)
    monkeypatch.setenv("MXNET_TPU_MEMORY_BUDGET", "0.5")
    assert ttel.memory.apply_budget(torch.device("cpu")) is None


def test_segments_equal_jax_and_cross_rank_raises():
    for args in ((0.3, 0.1, 0.0, 1), (0.05, 0.2, 0.01, 3)):
        assert ttel.distview.record_step_segments(*args) == \
            jtel.distview.record_step_segments(*args)
    assert ttel.histogram("mxtpu_step_segment_seconds").samples() == \
        jtel.histogram("mxtpu_step_segment_seconds").samples()
    # the cross-rank half is ported (test_torch_launch.py holds the
    # aggregator against JAX's): one process has no peer to wait for, and
    # the stream readers read as JAX's
    assert ttel.distview.pre_collective_barrier() is None
    for buf in ('{"step": 1}\n{"st', "\n[1]\nnot json\n"):
        assert ttel.distview.split_jsonl(buf) == \
            jtel.distview.split_jsonl(buf)
    assert ttel.distview.rank_jsonl_path("run.jsonl", 1) == \
        jtel.distview.rank_jsonl_path("run.jsonl", 1)
    assert ttel.distview.capture_status() == {"active": False, "last": None}


def test_profiler_chrome_trace_is_the_jax_format(tmp_path, monkeypatch):
    from mxnet_tpu_torch import profiler
    monkeypatch.setenv("MXNET_PROFILER_XLA_DIR", str(tmp_path / "dev"))
    path = str(tmp_path / "profile.json")
    profiler.profiler_set_config(mode="all", filename=path)
    profiler.profiler_set_state("run")
    try:
        with ttel.span("trainer.step", category="trainer"):
            x = tmx.nd.array(np.ones((2, 3)), ctx=tmx.cpu())
            y = tmx.nd.relu(x * 2)
    finally:
        profiler.profiler_set_state("stop")
    assert y.asnumpy().sum() == 12
    profiler.dump_profile()
    with open(path) as f:
        doc = json.load(f)
    assert set(doc) == {"traceEvents", "displayTimeUnit"}
    ev = doc["traceEvents"]
    assert {e["ph"] for e in ev} == {"X"}
    assert all(set(e) == {"name", "cat", "ph", "ts", "dur", "pid", "tid"}
               for e in ev)
    step = next(e for e in ev if e["name"] == "trainer.step")
    ops = [e for e in ev if e["cat"] == "operator"]
    assert [e["name"] for e in ops] == ["_mul_scalar", "relu"]
    assert all(step["ts"] <= e["ts"] <= step["ts"] + step["dur"]
               for e in ops)
    traces = profiler.device_traces()
    assert traces and traces[-1].startswith(str(tmp_path / "dev"))
    with open(traces[-1]) as f:
        assert "traceEvents" in json.load(f)
    assert not profiler.is_running()


def test_config_honored_variables_are_read(tmp_path):
    honored = [k for k, v in tmx.config.describe().items()
               if v[1] == "honored"]
    assert {"MXNET_PROFILER_AUTOSTART", "MXNET_PROFILER_MODE",
            "MXNET_PROFILER_FILENAME", "MXNET_PROFILER_XLA_DIR",
            "MXNET_TPU_TELEMETRY_JSONL", "MXNET_TPU_TELEMETRY_PORT",
            "MXNET_TPU_FLIGHT_DIR", "MXNET_TPU_FLIGHT_EVENTS",
            "MXNET_TPU_IOVIEW_EVERY", "MXNET_TPU_IOVIEW_WINDOW",
            "MXNET_TPU_MEMORY_BUDGET", "MXNET_TPU_TRACE_SAMPLE",
            "MXNET_TPU_TRACE_DIR", "MXNET_TPU_TRACE_RING",
            "MXNET_TPU_TRACE_SLOW_PCT", "MXNET_TPU_NUMERICS_EVERY",
            "MXNET_TPU_NUMERICS_STRICT", "MXNET_TPU_NUMERICS_LEDGER",
            "MXNET_TPU_NUMERICS_SPIKE", "MXNET_TPU_NUMERICS_DEAD"} \
        <= set(honored)
    jax_cat = mx.config.describe() if hasattr(mx.config, "describe") \
        else None
    pkg = os.path.join(ROOT, "mxnet_tpu_torch")
    text = ""
    for dirpath, _d, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py") and f != "config.py":
                with open(os.path.join(dirpath, f)) as fh:
                    text += fh.read()
    assert [k for k in honored if k not in text] == []
    if jax_cat is not None:
        for k in honored:
            if k in jax_cat:
                assert tmx.config.describe()[k][0] == jax_cat[k][0], k
