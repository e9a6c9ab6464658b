"""The port's launcher (``mxnet_tpu_torch/tools/launch.py``) and the
cross-rank half of ``telemetry.distview``, on the CPU.

Two jobs of two ranks:

* the restart drill (``tools.dist_train recovery --cpu 1``, the GPT at
  its tiny size), ``--restart-budget 1``: attempt 0 trains uninterrupted,
  then again with a checkpoint after step 2 (rank 0 writes it), after
  which rank 1 SIGKILLs itself; the watchdog tears the job down and
  relaunches it, and attempt 1 resumes from the step-2 checkpoint: its
  losses equal the uninterrupted run's to the bit.  With
  ``MXNET_TPU_TELEMETRY_JSONL`` set, each rank writes its own step log
  and the supervisor merges them into the ``mxtpu-run/1`` timeline, with
  the worker's death and the restart among its events;
* the SIGUSR1 capture (``tests/torch_dist_train.py capture``): the
  supervisor relays the signal, and each rank's handler
  (``MXNET_TPU_CAPTURE_DIR``) writes a flight snapshot and a profiler
  trace while it keeps stepping.

In process: the port's ``RunAggregator``, loaded by path as the launcher
loads it, writes the JAX aggregator's records from the same per-rank
streams, and ``summarize_run`` reads them as JAX's does; ``launch.py
--capture`` signals the workers a running job's supervisor stream names;
the launcher refuses ``--elastic``, ``--min-workers`` and ``--fleet``,
naming the next slice.
"""
import importlib.util
import json
import os
import signal
import subprocess
import sys
import time

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

from mxnet_tpu.telemetry import distview as jdistview  # noqa: E402

import torch_dist_common  # noqa: E402

WORKER = os.path.join(ROOT, "tests", "torch_dist_train.py")


def _by_path():
    """The port's distview loaded from its file, as the launcher does:
    stdlib imports only, no package."""
    spec = importlib.util.spec_from_file_location(
        "port_distview", os.path.join(ROOT, "mxnet_tpu_torch", "telemetry",
                                      "distview.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def drill(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("drill"))
    base = os.path.join(out, "run.jsonl")
    res = torch_dist_common.launch(
        ["-m", "mxnet_tpu_torch.tools.dist_train", "recovery", out,
         "--cpu", "1"], timeout=150,
        launcher_args=["--restart-budget", "1"],
        env={"MXNET_TPU_TELEMETRY_JSONL": base,
             "MXNET_TPU_HEARTBEAT_TIMEOUT": "60"})
    return out, base, res


def _doc(out, name, r):
    return json.load(open(os.path.join(out, "%s.rank%d.json" % (name, r))))


def test_restart_budget_relaunches_and_resumes_exactly(drill):
    out, _base, res = drill
    assert res.returncode == 0, res.stderr[-4000:]
    # rank 1's SIGKILL (137 through the launcher's shell), or rank 0's
    # failed collective against it, whichever the watchdog polls first
    assert "exited with code" in res.stderr
    assert "restarting job (attempt 1/1)" in res.stderr
    assert "job recovered after 1 restart(s)" in res.stderr
    for r in (0, 1):
        full, resumed = (_doc(out, n, r) for n in ("uninterrupted",
                                                   "resumed"))
        assert resumed["epoch"] == 2 and resumed["attempt"] == 1
        assert resumed["losses"] == full["losses"][2:]    # to the bit
        assert resumed["params"] == _doc(out, "resumed", 1 - r)["params"]


def test_run_timeline_records_the_ranks_and_the_restart(drill):
    _out, base, _res = drill
    for r in (0, 1):
        assert os.path.getsize(base + ".rank%d" % r) > 0
    recs = jdistview.read_run_timeline(base + ".run")
    assert recs[0]["schema"] == "mxtpu-run/1" and recs[0]["num_ranks"] == 2
    events = [r.get("event") for r in recs if r["kind"] == "event"]
    for e in ("job_start", "worker_start", "worker_death",
              "watchdog_restart", "job_end"):
        assert e in events, e
    steps = [r for r in recs if r["kind"] == "step"]
    assert steps and max(s["n_ranks"] for s in steps) == 2
    summary = _by_path().summarize_run(recs)
    assert summary == jdistview.summarize_run(recs)


def test_sigusr1_to_the_supervisor_captures_every_rank(tmp_path):
    out = str(tmp_path)
    p = torch_dist_common.start(
        [WORKER, "capture", out],
        env={"MXNET_TPU_CAPTURE_DIR": os.path.join(out, "cap"),
             "MXNET_TPU_CAPTURE_SECONDS": "0.5"})
    deadline = time.time() + 90
    while time.time() < deadline and not all(
            os.path.exists(os.path.join(out, "ready.rank%d" % r))
            for r in (0, 1)):
        time.sleep(0.2)
    time.sleep(1.0)
    os.kill(p.pid, signal.SIGUSR1)
    res = torch_dist_common.finish(p, timeout=90)
    assert res.returncode == 0, res.stderr[-4000:]
    for r in (0, 1):
        doc = json.load(open(os.path.join(out, "capture.rank%d.json" % r)))
        assert doc["trigger"] == "signal" and "error" not in doc
        assert doc["dir"].endswith("rank%d" % r)
        assert os.path.exists(doc["flight"]) and os.path.exists(doc["trace"])


def _feed(base, agg_ranks=2, steps=4):
    """Per-rank step logs: rank 1 the straggler, rank 0 waiting on it."""
    for r in range(agg_ranks):
        with open(jdistview.rank_jsonl_path(base, r), "a") as f:
            for s in range(1, steps + 1):
                wait = 0.0 if r == 1 else 0.1
                f.write(json.dumps({
                    "step": s, "ts": 100.0 + s, "step_time_s":
                    0.11 if r == 1 else 0.01 + wait,
                    "segments": {"compute": 0.01, "input_wait": 0.0,
                                 "collective_wait": wait}}) + "\n")


def _records(path):
    recs = jdistview.read_run_timeline(path)
    for r in recs:
        r.pop("ts", None)
    return recs


def test_aggregator_writes_the_jax_records(tmp_path, monkeypatch):
    monkeypatch.delenv("MXNET_TPU_FLIGHT_DIR", raising=False)
    port = _by_path()
    runs = {}
    for name, mod in (("port", port), ("jax", jdistview)):
        base = str(tmp_path / name / "run.jsonl")
        os.makedirs(os.path.dirname(base))
        agg = mod.RunAggregator(base, 2)
        _feed(base)
        agg.note_event({"event": "worker_start", "rank": 0, "pid": 1})
        assert agg.poll() == 8
        agg.close()
        runs[name] = _records(base + ".run")
    assert runs["port"] == runs["jax"]
    assert port.summarize_run(runs["port"]) == \
        jdistview.summarize_run(runs["jax"])
    assert port.split_jsonl('{"a": 1}\n{"b"') == \
        jdistview.split_jsonl('{"a": 1}\n{"b"')
    assert port.rank_jsonl_path("x", 3) == jdistview.rank_jsonl_path("x", 3)


@pytest.mark.parametrize("flag", [["--elastic"], ["--min-workers", "1"],
                                  ["--fleet"]])
def test_next_slice_flags_raise(flag):
    res = subprocess.run([sys.executable, torch_dist_common.LAUNCH, "-n",
                          "1", *flag, "true"], capture_output=True,
                         text=True, timeout=60)
    assert res.returncode == 2
    assert "next slice" in res.stderr and flag[0] in res.stderr


_LISTENER = """
import os, signal, sys, time
def got(sig, frame):
    open(sys.argv[1], "w").write("usr1")
    sys.exit(0)
signal.signal(signal.SIGUSR1, got)
open(sys.argv[1] + ".ready", "w").close()
time.sleep(60)
"""


def test_capture_signals_the_workers_the_jsonl_names(tmp_path):
    """``launch.py --capture --jsonl`` reads a running job's worker pids
    from its supervisor stream and sends each worker's process group
    SIGUSR1; a finished job (``job_end``) is left alone."""
    mark = str(tmp_path / "got")
    worker = subprocess.Popen([sys.executable, "-c", _LISTENER, mark],
                              start_new_session=True)
    try:
        deadline = time.time() + 30
        while not os.path.exists(mark + ".ready") and time.time() < deadline:
            time.sleep(0.05)
        jsonl = tmp_path / "run.jsonl"
        events = [{"event": "job_start", "pid": os.getpid()},
                  {"event": "worker_start", "rank": 0, "pid": worker.pid}]
        jsonl.write_text("".join(json.dumps(e) + "\n" for e in events))
        res = subprocess.run([sys.executable, torch_dist_common.LAUNCH,
                              "--capture", "--jsonl", str(jsonl)],
                             capture_output=True, text=True, timeout=60)
        assert res.returncode == 0, res.stderr
        assert "signaled 1 worker(s): rank 0 (pid %d)" % worker.pid \
            in res.stdout
        assert worker.wait(timeout=30) == 0
        assert open(mark).read() == "usr1"
        with open(jsonl, "a") as f:
            f.write(json.dumps({"event": "job_end", "pid": 1}) + "\n")
        res = subprocess.run([sys.executable, torch_dist_common.LAUNCH,
                              "--capture", "--jsonl", str(jsonl)],
                             capture_output=True, text=True, timeout=60)
        assert res.returncode == 1 and "no live workers" in res.stderr
    finally:
        if worker.poll() is None:
            worker.kill()
            worker.wait()
