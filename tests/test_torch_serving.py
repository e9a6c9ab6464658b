"""The whole serving slice on the CPU: a tiny GPT checkpoint written by the
JAX package, served by the port's Predictor, BatchLadder, Batcher and
Server, held against the JAX Predictor; the scheduler's coalescing, EDF
order, shedding and fail-fast against fake ladders."""
import json
import os
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.ops.flash_attention import flash_attention_fwd
from mxnet_tpu_torch.predictor import pad_batch
from mxnet_tpu_torch.serving import (BatchLadder, Batcher, RequestShed,
                                     Server, ladder_rungs)
from mxnet_tpu_torch.serving.__main__ import main as serve_main

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "examples", "transformer"))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
import train_lm  # noqa: E402

VOCAB, SEQ = 64, 128
RTOL, ATOL = 1e-4, 1e-5       # accumulation order over two layers


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    """A tiny GPT checkpoint (vocab 64, seq 128, d_model 32, 2 heads,
    2 layers) written by the JAX package."""
    net = train_lm.gpt_symbol(VOCAB, SEQ, d_model=32, n_heads=2, n_layers=2,
                              dropout=0.0)
    shapes, _, _ = net.infer_shape(data=(1, SEQ), softmax_label=(1, SEQ))
    rng = np.random.RandomState(0)
    params = {}
    for name, shape in zip(net.list_arguments(), shapes):
        if name not in ("data", "softmax_label"):
            params["arg:" + name] = jmx.nd.array(
                rng.normal(0, 0.2, shape).astype(np.float32))
    prefix = str(tmp_path_factory.mktemp("gpt") / "gpt")
    net.save(prefix + "-symbol.json")
    jmx.nd.save(prefix + "-0000.params", params)
    return prefix


def _tokens(rows, seed=1):
    return np.random.RandomState(seed).randint(
        0, VOCAB, (rows, SEQ)).astype(np.float32)


def _port_predictor(prefix, batch=1):
    return tmx.Predictor(prefix + "-symbol.json", prefix + "-0000.params",
                         {"data": (batch, SEQ)}, ctx=tmx.cpu())


def test_port_predictor_matches_jax_predictor(checkpoint):
    x = _tokens(2)
    jpred = jmx.Predictor(checkpoint + "-symbol.json",
                          checkpoint + "-0000.params",
                          {"data": (2, SEQ), "softmax_label": (2, SEQ)})
    want = jpred.forward(data=x).get_output(0)
    tpred = _port_predictor(checkpoint, batch=2)
    got = tpred.forward(data=x).get_output(0)
    assert got.shape == want.shape == (2 * SEQ, VOCAB)
    np.testing.assert_allclose(got, want, RTOL, ATOL)


def test_port_predictor_from_bytes_and_dict(checkpoint):
    x = _tokens(1, seed=2)
    ref = _port_predictor(checkpoint).forward(data=x).get_output(0)
    with open(checkpoint + "-0000.params", "rb") as f:
        blob = f.read()
    with open(checkpoint + "-symbol.json") as f:
        js = f.read()
    from_bytes = tmx.Predictor(js, blob, {"data": (1, SEQ)}, ctx=tmx.cpu())
    params = tmx.nd.load(checkpoint + "-0000.params", ctx=tmx.cpu())
    from_dict = tmx.Predictor(js, params, {"data": (1, SEQ)}, ctx=tmx.cpu())
    for pred in (from_bytes, from_dict):
        np.testing.assert_array_equal(pred.forward(data=x).get_output(0), ref)


def test_partial_batch_is_padded_and_sliced_by_sequence(checkpoint):
    x = _tokens(3, seed=3)
    pred4 = _port_predictor(checkpoint, batch=4)
    part = pred4.forward(data=x[:1]).get_output(0)
    assert part.shape == (SEQ, VOCAB)       # one whole sequence back
    alone = _port_predictor(checkpoint).forward(data=x[:1]).get_output(0)
    np.testing.assert_allclose(part, alone, RTOL, ATOL)
    with pytest.raises(tmx.MXNetError, match="serving batch ladder"):
        pred4.forward(data=_tokens(5))


def test_predictor_defaults_to_the_card(checkpoint):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(tmx.MXNetError, match="no CUDA device"):
        tmx.Predictor(checkpoint + "-symbol.json",
                      checkpoint + "-0000.params", {"data": (1, SEQ)})


def test_ladder_dispatch_matches_oneshot_forward(checkpoint):
    pred = _port_predictor(checkpoint)
    ladder = BatchLadder(pred, rungs=(1, 4))
    assert ladder.warmed and set(ladder.describe()["wall_ms"]) == {"1", "4"}
    x = _tokens(3, seed=4)
    before = flash_attention_fwd.launches
    outs = ladder.dispatch(4, {"data": pad_batch(x, 4)})
    assert flash_attention_fwd.launches == before   # CPU: plain path
    ref = pred.reshaped({"data": (3, SEQ)}).forward(data=x).get_output(0)
    np.testing.assert_allclose(outs[0][:3 * SEQ], ref, RTOL, ATOL)
    assert ladder.pick_rung(2) == 4 and ladder.pick_rung(5) is None


def test_ladder_rungs_parsing():
    assert ladder_rungs("1,4,16") == (1, 4, 16)
    assert ladder_rungs((8, 2)) == (2, 8)
    with pytest.raises(tmx.MXNetError):
        ladder_rungs("0,4")
    with pytest.raises(tmx.MXNetError):
        ladder_rungs("nope")


# --------------------------------------------------------------- fake ladders
class FakeLadder:
    """Outputs are the input rows times two.  ``gate``: an Event each
    dispatch waits on (so the queue really backs up); ``fail``: dispatches
    that raise before the next one succeeds."""

    def __init__(self, rungs=(1, 4), wall=0.0005, gate=None, fail=0):
        self.rungs = tuple(rungs)
        self.max_rung = self.rungs[-1]
        self.input_names = ["data"]
        self._wall = wall
        self.gate = gate
        self.entered = threading.Event()
        self.fail = fail
        self.dispatches = []

    def input_tail(self, name):
        return (3,)

    def input_dtype(self, name):
        return np.float32

    def pick_rung(self, rows):
        for r in self.rungs:
            if r >= rows:
                return r
        return None

    def estimate_wall(self, rung):
        return self._wall

    def observe_wall(self, rung, wall):
        pass

    def dispatch(self, rung, feed):
        self.entered.set()
        if self.gate is not None and not self.gate.wait(30):
            raise RuntimeError("gate never opened")
        if self.fail:
            self.fail -= 1
            raise RuntimeError("injected dispatch failure")
        self.dispatches.append((rung, feed["data"].shape[0],
                                feed["data"][:, 0].tolist()))
        return [feed["data"] * 2.0]


def _rows(n, fill=1.0):
    return {"data": np.full((n, 3), fill, np.float32)}


def _join(threads):
    for t in threads:
        t.join(30)
    assert not any(t.is_alive() for t in threads)


def test_batcher_coalesces_concurrent_requests_into_one_rung():
    lad = FakeLadder(rungs=(1, 4))
    bat = Batcher(lad, window_ms=200, queue_depth=16,
                  default_deadline_ms=5000)
    try:
        results = {}
        threads = [threading.Thread(
            target=lambda i=i: results.__setitem__(
                i, bat.submit(_rows(1, fill=float(i))))) for i in range(3)]
        for t in threads:
            t.start()
        _join(threads)
        assert [d[:2] for d in lad.dispatches] == [(4, 4)]
        assert bat.dispatch_counts() == {4: 1}
        for i, out in results.items():
            assert out[0].shape == (1, 3)
            np.testing.assert_allclose(out[0], float(i) * 2.0)
        out = bat.submit({"data": np.ones((3,), np.float32)})  # one row
        assert out[0].shape == (1, 3)
    finally:
        bat.close()


def test_batcher_edf_orders_most_urgent_first():
    lad = FakeLadder(rungs=(2,))
    bat = Batcher(lad, window_ms=60, queue_depth=16,
                  default_deadline_ms=5000, start=False)
    done = []

    def go(fill, deadline_ms):
        done.append(bat.submit(_rows(1, fill=fill), deadline_ms=deadline_ms))

    threads = [threading.Thread(target=go, args=a)
               for a in ((1.0, 4000), (2.0, 900), (3.0, 2000))]
    for t in threads:
        t.start()
    deadline = time.monotonic() + 10
    while bat.queue_depth() < 3 and time.monotonic() < deadline:
        time.sleep(0.005)
    bat._thread.start()
    _join(threads)
    bat.close()
    assert len(done) == 3
    # the two most urgent ride the first dispatch, most urgent first
    assert lad.dispatches[0][2] == [2.0, 3.0]
    assert lad.dispatches[1][2][0] == 1.0


def test_batcher_sheds_on_queue_full():
    gate = threading.Event()
    lad = FakeLadder(rungs=(1,), gate=gate)
    bat = Batcher(lad, window_ms=1, queue_depth=2, default_deadline_ms=10000)
    try:
        oks = []
        first = threading.Thread(target=lambda: oks.append(
            bat.submit(_rows(1), timeout=30)))
        first.start()
        assert lad.entered.wait(10)           # the scheduler is blocked
        queued = [threading.Thread(target=lambda: oks.append(
            bat.submit(_rows(1), timeout=30))) for _ in range(2)]
        for t in queued:
            t.start()
        deadline = time.monotonic() + 10
        while bat.queue_depth() < 2 and time.monotonic() < deadline:
            time.sleep(0.005)
        with pytest.raises(RequestShed) as ei:
            bat.submit(_rows(1))
        assert ei.value.reason == "queue_full"
        gate.set()
        _join([first] + queued)
        assert len(oks) == 3
    finally:
        gate.set()
        bat.close()


def test_batcher_sheds_hopeless_deadline_at_submit():
    lad = FakeLadder(wall=10.0)
    bat = Batcher(lad, window_ms=1, queue_depth=8, default_deadline_ms=50)
    try:
        with pytest.raises(RequestShed) as ei:
            bat.submit(_rows(1))
        assert ei.value.reason == "deadline"
        with pytest.raises(RequestShed):
            bat.submit(_rows(1), deadline_ms=0)
        assert lad.dispatches == []
    finally:
        bat.close()


def test_batcher_fails_a_batch_fast_and_keeps_draining():
    lad = FakeLadder(fail=1)
    bat = Batcher(lad, window_ms=1, queue_depth=8, default_deadline_ms=5000)
    try:
        t0 = time.monotonic()
        with pytest.raises(RuntimeError, match="injected"):
            bat.submit(_rows(1))
        assert time.monotonic() - t0 < 2.0
        assert bat.submit(_rows(1))[0].shape == (1, 3)
        assert bat.alive
        with pytest.raises(tmx.MXNetError, match="largest ladder rung"):
            bat.submit(_rows(5))
    finally:
        bat.close()


# ------------------------------------------------------------- front door
def test_server_end_to_end(checkpoint):
    pred = _port_predictor(checkpoint)
    ladder = BatchLadder(pred, rungs=(1, 4))
    bat = Batcher(ladder, window_ms=2, queue_depth=8,
                  default_deadline_ms=5000)
    server = Server(ladder, batcher=bat, port=0, host="127.0.0.1").start()
    base = "http://127.0.0.1:%d" % server.port
    x = _tokens(2, seed=5)

    def post(doc):
        req = urllib.request.Request(
            base + "/predict", data=json.dumps(doc).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=30) as r:
            return json.loads(r.read())

    try:
        with urllib.request.urlopen(base + "/healthz", timeout=10) as r:
            doc = json.loads(r.read())
        assert r.status == 200 and doc["status"] == "ok"
        assert doc["ladder"]["rungs"] == [1, 4]
        doc = post({"data": x.tolist()})
        got = np.asarray(doc["outputs"][0], np.float32)
        assert got.shape == (2 * SEQ, VOCAB) and doc["rows"] == 2 * SEQ
        ref = pred.reshaped({"data": (2, SEQ)}).forward(data=x).get_output(0)
        np.testing.assert_allclose(got, ref, RTOL, ATOL)
        with pytest.raises(urllib.error.HTTPError) as ei:
            post({"data": x[:1].tolist(), "deadline_ms": 1e-6})
        assert ei.value.code == 503
        assert json.loads(ei.value.read())["shed"] == "deadline"
        with pytest.raises(urllib.error.HTTPError) as ei:
            post({"data": [[1.0, 2.0]]})      # wrong row shape
        assert ei.value.code == 500
    finally:
        server.close()
        # the Server started the process-wide SLO ticker: stop it, so
        # later tests in this worker judge only their own traffic
        tmx.telemetry.slo.stop_ticker()
    assert not bat.alive


def test_chip_smoke_serve_phase_on_cpu():
    """chip_smoke.py's serve phase, as the card runs it, at the tiny size."""
    out = chip_smoke.serve_phase(tmx.cpu(), {"vocab": VOCAB, "seq": SEQ,
                                             "d_model": 32, "heads": 2,
                                             "layers": 2})
    assert out["requests"] == 8 and out["launches"] == 0
    assert sum(out["dispatches_per_rung"].values()) >= 3
    assert out["max_abs_dlogp"] == 0.0


def test_cli_refuses_what_is_not_ported(checkpoint):
    """Both routes bind gpu(0): without a card and without --cpu 1, the
    zoo route and the checkpoint route raise before serving."""
    if not torch.cuda.is_available():
        with pytest.raises(tmx.MXNetError, match="no CUDA device"):
            serve_main(["--model", "mlp"])
        with pytest.raises(tmx.MXNetError, match="no CUDA device"):
            serve_main(["--checkpoint", checkpoint, "--data-shape",
                        str(SEQ), "--ladder", "1,4"])
