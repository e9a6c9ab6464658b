"""The telemetry wired through the port's training paths, on the CPU at a
tiny size: a 3-step ShardedTrainer run with every sink on gives the same
losses to the bit as with them off and one JSONL line a step, which the
JAX package's ``run_top`` and ``io_top`` read unchanged; numerics on
sampled steps and their ledger; ``Module.fit``'s spans and records; the
preemption handler's flight dump; the backpressure controller;
``tools.bench --dry-run`` with the CPU asked for; chip_smoke's
telemetry_train phase at a tiny size."""
import contextlib
import importlib.util
import io
import json
import os
import sys

import numpy as np
import pytest

import torch_threads  # noqa: F401  (xdist workers share the cores)

from mxnet_tpu import telemetry as jtel
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import telemetry as ttel
from mxnet_tpu_torch.models import get_model
from mxnet_tpu_torch.parallel import ShardedTrainer, build_mesh

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402

ENV = ("MXNET_TPU_TELEMETRY_JSONL", "MXNET_TPU_FLIGHT_DIR",
       "MXNET_TPU_TRACE_DIR", "MXNET_TPU_IOVIEW_EVERY",
       "MXNET_TPU_NUMERICS_EVERY", "MXNET_TPU_NUMERICS_LEDGER",
       "MXNET_PROFILER_XLA_DIR", "MXNET_TPU_BACKPRESSURE",
       "MXNET_TPU_IOVIEW_WINDOW", "BENCH_DRYRUN")


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    for k in ENV:
        monkeypatch.delenv(k, raising=False)
    ttel.reset()
    jtel.reset()
    tmx.io_resume.track(None)
    yield
    ttel.reset()
    jtel.reset()
    tmx.io_resume.track(None)


def _tool(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "tools", "%s.py" % name))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _batches(n=3, batch=8, seed=0):
    rng = np.random.RandomState(seed)
    return [{"data": rng.uniform(-1, 1, (batch, 20)).astype(np.float32),
             "softmax_label": rng.randint(0, 4, batch).astype(np.float32)}
            for _ in range(n)]


def _trainer(batch=8):
    return ShardedTrainer(
        get_model("mlp", num_classes=4), build_mesh(devices=[tmx.cpu()]),
        data_shapes={"data": (batch, 20)},
        label_shapes={"softmax_label": (batch,)}, optimizer="sgd",
        learning_rate=0.1, momentum=0.9, dtype="float32", seed=0)


def _run(batches, through_queue=True):
    trainer = _trainer()
    if through_queue:
        src = tmx.io.NDArrayIter(
            np.concatenate([b["data"] for b in batches]),
            np.concatenate([b["softmax_label"] for b in batches]),
            batch_size=8)
        queue = tmx.io.DevicePrefetchIter(src, trainer.put_batch, depth=2)
        ttel.ioview.track(queue)
        losses = [trainer.step(b) for b in queue]
    else:
        losses = [trainer.step(b) for b in batches]
    return [float(x) for x in losses], trainer


def test_three_steps_equal_with_every_sink_on(tmp_path, monkeypatch):
    batches = _batches()
    off, _t = _run(batches)
    off_inline, _t = _run(batches, through_queue=False)
    base = str(tmp_path / "run.jsonl")
    jsonl = jtel.distview.rank_jsonl_path(base, 0)
    monkeypatch.setenv("MXNET_TPU_TELEMETRY_JSONL", jsonl)
    monkeypatch.setenv("MXNET_TPU_FLIGHT_DIR", str(tmp_path / "flight"))
    monkeypatch.setenv("MXNET_TPU_TRACE_DIR", str(tmp_path / "traces"))
    monkeypatch.setenv("MXNET_PROFILER_XLA_DIR", str(tmp_path / "dev"))
    tmx.profiler.profiler_set_config("all", str(tmp_path / "p.json"))
    tmx.profiler.profiler_set_state("run")
    try:
        ttel.reset()
        on, _t = _run(batches)
    finally:
        tmx.profiler.profiler_set_state("stop")
        tmx.profiler.dump_profile()
    assert on == off == off_inline
    with open(jsonl) as f:
        lines = [json.loads(x) for x in f]
    assert [r["step"] for r in lines] == [1, 2, 3]
    for r in lines:
        assert r["samples"] == 8 and r["step_time_s"] > 0
        assert "trainer.step" in r["spans"]
        assert set(r["segments"]) == {"compute", "input_wait",
                                      "collective_wait"}
        assert "io" in r
    # the queue's worker stages ahead: the batches land in the first
    # records, three in all
    assert sum(r["io"]["stages"].get("device_stage", {}).get("items", 0)
               for r in lines) == 3
    assert lines[0]["counters"]["mxtpu_step_total"] == 1
    assert os.listdir(tmp_path / "traces")
    assert not os.path.exists(tmp_path / "flight")     # nothing failed
    agg = jtel.distview.RunAggregator(base, 1)
    agg.poll()
    agg.close()
    run_top, io_top = _tool("run_top"), _tool("io_top")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert run_top.main([base + ".run", "--summarize", "--json"]) == 0
    summary = json.loads(buf.getvalue())
    assert summary["steps_total"] == 3 if "steps_total" in summary \
        else summary
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert io_top.main([jsonl, "--json"]) == 0
    rollup = json.loads(buf.getvalue())
    assert rollup["schema"] == "mxtpu-iotop/1"
    assert rollup["stages"]["device_stage"]["items"] == 3
    assert rollup["bottleneck"]["verdict"] in chip_smoke.IOVIEW_VERDICTS


def test_staging_inside_the_step_is_input_wait():
    trainer = _trainer()
    trainer.step(_batches(1)[0])
    seg = ttel.histogram("mxtpu_step_segment_seconds").samples()
    waits = {dict(k)["segment"]: v["sum"] for k, v in seg.items()}
    assert waits["input_wait"] > 0
    assert ttel.ioview.snapshot()["stages"]["device_stage"]["items"] == 1
    staged = trainer.put_batch(_batches(1)[0])
    ttel.reset()
    trainer.step(staged)
    seg = ttel.histogram("mxtpu_step_segment_seconds").samples()
    assert {dict(k)["segment"]: v["sum"] for k, v in seg.items()}[
        "input_wait"] == 0
    losses = trainer.run_steps(staged, 3)
    assert losses.shape == (3,)
    assert ttel.counter("mxtpu_step_total").get() == 4
    assert ttel.report()["phases"]["trainer.run_steps"]["count"] == 1


def test_numerics_sampled_steps_and_ledger(tmp_path, monkeypatch):
    batches = _batches()
    off, _t = _run(batches, through_queue=False)
    ledger = str(tmp_path / "num.jsonl")
    monkeypatch.setenv("MXNET_TPU_NUMERICS_EVERY", "2")
    monkeypatch.setenv("MXNET_TPU_NUMERICS_LEDGER", ledger)
    on, _t = _run(batches, through_queue=False)
    assert on == off
    recs = jtel.numerics.read_ledger(ledger)
    assert [r["step"] for r in recs] == [1, 3]
    assert all(r["grad_norm"] > 0 for r in recs)
    assert ttel.numerics.summary()["sampled_steps"] == 2
    assert ttel.gauge("mxtpu_grad_global_norm").get() == \
        recs[-1]["grad_norm"]


def test_preemption_dumps_the_flight_ring(tmp_path, monkeypatch):
    import signal
    monkeypatch.setenv("MXNET_TPU_FLIGHT_DIR", str(tmp_path / "flight"))
    trainer = _trainer()
    os.makedirs(tmp_path / "ck")
    handler = trainer.install_preemption_handler(
        str(tmp_path / "ck" / "m"), exit_process=False)
    try:
        for b in _batches(2):
            trainer.step(b)
        os.kill(os.getpid(), signal.SIGTERM)
    finally:
        signal.signal(signal.SIGTERM, signal.SIG_DFL)
    assert handler.triggered
    names = os.listdir(tmp_path / "flight")
    assert len(names) == 1 and names[0].endswith("sigterm.json")
    with open(tmp_path / "flight" / names[0]) as f:
        doc = json.load(f)
    kinds = [(e["kind"], e.get("step")) for e in doc["events"]]
    assert ("step_begin", 2) in kinds and ("preemption", None) in kinds
    fr = _tool("flight_read")
    with contextlib.redirect_stdout(io.StringIO()):
        assert fr.main([str(tmp_path / "flight" / names[0])]) == 0


def test_fault_in_a_step_dumps_once(tmp_path, monkeypatch):
    monkeypatch.setenv("MXNET_TPU_FLIGHT_DIR", str(tmp_path))
    tmx.resilience.configure_faults("trainer.step:n=1")
    try:
        with pytest.raises(tmx.MXNetError):
            _trainer().step(_batches(1)[0])
    finally:
        tmx.resilience.clear_faults()
    assert len(os.listdir(tmp_path)) == 1
    assert ttel.counter("mxtpu_fault_injected_total").labels(
        site="trainer.step").get() == 1


def test_module_fit_spans_and_records(tmp_path, monkeypatch):
    jsonl = str(tmp_path / "fit.jsonl")
    monkeypatch.setenv("MXNET_TPU_TELEMETRY_JSONL", jsonl)
    rng = np.random.RandomState(0)
    it = tmx.io.NDArrayIter(rng.randn(32, 20).astype(np.float32),
                            rng.randint(0, 4, 32).astype(np.float32),
                            batch_size=8)
    mod = tmx.mod.Module(get_model("mlp", num_classes=4),
                         context=[tmx.cpu()])
    mod.fit(it, num_epoch=1, optimizer="sgd",
            initializer=tmx.init.Xavier(rng=np.random.RandomState(0)))
    with open(jsonl) as f:
        lines = [json.loads(x) for x in f]
    assert [r["step"] for r in lines] == [1, 2, 3, 4]
    assert all({"data.fetch", "executor.forward", "executor.backward"}
               <= set(r["spans"]) for r in lines)


def test_backpressure_moves_the_prefetch_depth(monkeypatch):
    monkeypatch.setenv("MXNET_TPU_BACKPRESSURE", "1")
    src = tmx.io.NDArrayIter(np.zeros((16, 2), np.float32),
                             np.zeros(16, np.float32), batch_size=4)
    queue = tmx.io.DevicePrefetchIter(src, lambda h: h, depth=2)
    try:
        ctl = tmx.io_resume.maybe_controller(queue)
        assert ctl is not None
        producer = {"verdict": "producer-bound", "stage": "decode"}
        assert ctl.tick(producer) is None
        moved = ctl.tick(producer)
        assert moved["to"] == 3 and queue.depth() == 3
        assert ttel.counter("mxtpu_backpressure_adjust_total").labels(
            knob="device_prefetch_depth", direction="raise").get() == 1
        assert len(list(queue)) == 4
    finally:
        queue.close()


def test_bench_dry_run_on_the_cpu(capsys):
    from mxnet_tpu_torch.tools import bench
    out = bench.main(["--dry-run", "--cpu"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == json.loads(json.dumps(out))
    assert line["metric"] == "dryrun_mlp_train_samples_per_sec_per_chip"
    assert line["telemetry"]["steps"] == 5 and line["valid"]
    assert set(line) >= {"value", "unit", "vs_baseline", "fusion", "io",
                         "numerics", "telemetry"}
    # the ported autotune block and the plan-search A/B of the MLP
    assert line["autotune"]["schema"] == "mxtpu-tunecache/1"
    ab = line["fusion"]["plansearch"]
    assert ab["cached"] or ab["wall_s"] <= ab["greedy_wall_s"]
    assert line["costdb"]["schema"] == "mxtpu-costdb/1"
    assert line["fusion"]["ab_unfused"]["step_program_eqns"] > \
        line["fusion"]["step_program_eqns"]


def test_chip_smoke_telemetry_phase_at_a_tiny_size(tmp_path):
    recs, _s = chip_smoke.make_image_records(
        str(tmp_path), {"train": (24, 0)}, size=40)
    out = chip_smoke.telemetry_train_phase(
        tmx.cpu(), recs, str(tmp_path), steps=4, profiled=(2, 3), layers=8,
        image=16, batch=4, dtype="float32")
    assert out["losses_equal"] and len(out["losses"]) == 4
    assert out["ioview"]["items"] == {"decode": 16, "batch": 16,
                                      "device_stage": 4}
    assert out["chrome_trace"]["trainer_step_spans"] == 2
    assert out["chrome_trace"]["operator_events_outside_steps"] == 0
    assert out["dry_run"]["telemetry_steps"] == 5
    assert out["kernel_launches_per_step"]["matmul_stats"] == 0
