"""The port's io, metric and callback modules against the JAX package's, on
the CPU, from the same numpy-made data.

Iterators: the batches (data, label, pad) are compared bit for bit, over
two epochs so that ``roll_over`` and ``reset`` are covered; shuffling draws
from numpy's global generator in both packages, seeded before each
construction.  Metrics: each one's value after three updates equals the
JAX metric's within rtol 1e-6 (the port sums on the predictions' device,
in f64 where the JAX code sums f32 numpy arrays).  Callbacks: Speedometer's
log line has the JAX form; do_checkpoint's files load in the JAX package.
"""
import logging
import os
import re
import struct

import numpy as np
import pytest

import mxnet_tpu as jmx

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.base import MXNetError


@pytest.fixture(autouse=True)
def _no_pending_data_state():
    """Each package's ``load_checkpoint`` stashes the ``data_state`` of a
    manifest for its next ``fit`` in the process, and a port ``fit``
    tracks its iterator for the next checkpoint; clear both after each
    test so that no later test (of this file or another in the same
    worker) resumes its iterator from a checkpoint of this one."""
    yield
    jmx.io_resume.clear_pending()
    tmx.io_resume.clear_pending()
    tmx.io_resume.track(None)


def _batches(it, epochs=2):
    out = []
    for _ in range(epochs):
        for b in it:
            out.append(([d.asnumpy() for d in b.data],
                        [lab.asnumpy() for lab in b.label], b.pad))
        it.reset()
    return out


def _same(got, want):
    assert len(got) == len(want)
    for (gd, gl, gp), (wd, wl, wp) in zip(got, want):
        assert gp == wp
        for g, w in zip(gd + gl, wd + wl):
            assert g.dtype == w.dtype and np.array_equal(g, w)


def _data(n=23, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(n, 3, 2).astype(np.float32),
            rng.randint(0, 5, n).astype(np.float32))


@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("handle", ["pad", "discard", "roll_over"])
def test_ndarray_iter_matches_jax(handle, shuffle):
    x, y = _data()
    np.random.seed(7)
    jit = jmx.io.NDArrayIter(x, y, batch_size=5, shuffle=shuffle,
                             last_batch_handle=handle)
    np.random.seed(7)
    pit = tmx.io.NDArrayIter(x, y, batch_size=5, shuffle=shuffle,
                             last_batch_handle=handle)
    assert [tuple(d) for d in pit.provide_data] == \
        [tuple(d) for d in jit.provide_data]
    assert [tuple(d) for d in pit.provide_label] == \
        [tuple(d) for d in jit.provide_label]
    got = _batches(pit)
    _same(got, _batches(jit))
    assert all(d.context == tmx.cpu() for d in pit.next().data)


def test_ndarray_iter_takes_dicts_and_several_arrays():
    x, y = _data(12)
    kw = dict(batch_size=4)
    jit = jmx.io.NDArrayIter({"a": x, "b": x * 2}, {"lab": y}, **kw)
    pit = tmx.io.NDArrayIter({"a": x, "b": x * 2}, {"lab": y}, **kw)
    assert [d.name for d in pit.provide_data] == ["a", "b"]
    _same(_batches(pit, 1), _batches(jit, 1))
    with pytest.raises(MXNetError, match="smaller than data size"):
        tmx.io.NDArrayIter(x, y, batch_size=13)


def test_resize_iter_matches_jax():
    x, y = _data(10)
    jit = jmx.io.ResizeIter(jmx.io.NDArrayIter(x, y, batch_size=4), 5)
    pit = tmx.io.ResizeIter(tmx.io.NDArrayIter(x, y, batch_size=4), 5)
    _same(_batches(pit), _batches(jit))


def test_prefetching_iter_matches_jax():
    x, y = _data(17)
    x2 = x * 3
    def make(mx):
        return mx.io.PrefetchingIter(
            [mx.io.NDArrayIter(x, y, batch_size=4),
             mx.io.NDArrayIter({"data2": x2}, batch_size=4)],
            rename_data=[{"data": "a"}, {"data2": "b"}])
    jit, pit = make(jmx), make(tmx)
    assert [d.name for d in pit.provide_data] == ["a", "b"]
    _same(_batches(pit), _batches(jit))


def test_prefetching_iter_raises_a_fetch_error():
    class Broken(tmx.io.DataIter):
        provide_data = [tmx.io.DataDesc("data", (2, 3))]
        provide_label = []

        def next(self):
            raise ValueError("bad read")
    it = tmx.io.PrefetchingIter(Broken(2))
    with pytest.raises(ValueError, match="bad read"):
        it.next()


def _write_idx(path, arr, magic):
    with open(path, "wb") as f:
        f.write(struct.pack(">i", magic))
        f.write(struct.pack(">" + "i" * arr.ndim, *arr.shape))
        f.write(arr.astype(np.uint8).tobytes())


@pytest.mark.parametrize("flat", [False, True])
def test_mnist_iter_matches_jax(tmp_path, flat):
    rng = np.random.RandomState(1)
    img, lab = tmp_path / "img", tmp_path / "lab"
    _write_idx(str(img), rng.randint(0, 256, (30, 28, 28)), 2051)
    _write_idx(str(lab), rng.randint(0, 10, (30,)), 2049)
    kw = dict(image=str(img), label=str(lab), batch_size=8, shuffle=True,
              flat=flat, seed=3)
    jit, pit = jmx.io.MNISTIter(**kw), tmx.io.MNISTIter(**kw)
    assert [tuple(d) for d in pit.provide_data] == \
        [tuple(d) for d in jit.provide_data]
    _same(_batches(pit), _batches(jit))


@pytest.mark.parametrize("round_batch", [True, False])
def test_csv_iter_matches_jax(tmp_path, round_batch):
    x, y = _data(11)
    data, label = tmp_path / "d.csv", tmp_path / "l.csv"
    np.savetxt(data, x.reshape(11, -1), delimiter=",")
    np.savetxt(label, y, delimiter=",")
    kw = dict(data_csv=str(data), data_shape=(3, 2), label_csv=str(label),
              batch_size=4, round_batch=round_batch)
    _same(_batches(tmx.io.CSVIter(**kw)), _batches(jmx.io.CSVIter(**kw)))
    kw.pop("label_csv")
    _same(_batches(tmx.io.CSVIter(**kw)), _batches(jmx.io.CSVIter(**kw)))


# ------------------------------------------------------------------ metrics
def _pair(n=32, classes=6, seed=0):
    rng = np.random.RandomState(seed)
    logits = rng.randn(n, classes).astype(np.float32)
    prob = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    return rng.randint(0, classes, n).astype(np.float32), \
        prob.astype(np.float32)


def _feed(metric_j, metric_p, batches):
    for labels, preds in batches:
        metric_j.update([jmx.nd.array(x) for x in labels],
                        [jmx.nd.array(x) for x in preds])
        metric_p.update([tmx.nd.array(x, ctx=tmx.cpu()) for x in labels],
                        [tmx.nd.array(x, ctx=tmx.cpu()) for x in preds])
    jn, jv = metric_j.get()
    pn, pv = metric_p.get()
    assert pn == jn
    np.testing.assert_allclose(pv, jv, rtol=1e-6)
    return pv


def _classification(classes=6, seed=0):
    out = []
    for i in range(3):
        lab, prob = _pair(classes=classes, seed=seed + i)
        out.append(([lab], [prob]))
    return out


def _binary():
    return _classification(classes=2, seed=10)


def _regression():
    rng = np.random.RandomState(4)
    return [([rng.randn(16).astype(np.float32)],
             [rng.randn(16, 1).astype(np.float32)]) for _ in range(3)]


def _tokens(ignore=None):
    """Perplexity's shape: (batch, seq) labels against (batch * seq,
    vocab) probabilities."""
    out = []
    for i in range(3):
        lab, prob = _pair(n=4 * 8, classes=11, seed=20 + i)
        lab = lab.reshape(4, 8)
        if ignore is not None:
            lab[0, :3] = ignore
        out.append(([lab], [prob]))
    return out


@pytest.mark.parametrize("name,make,batches", [
    ("acc", lambda mx: mx.metric.Accuracy(), _classification),
    ("create_acc", lambda mx: mx.metric.create("acc"), _classification),
    ("top_k", lambda mx: mx.metric.TopKAccuracy(top_k=3), _classification),
    ("f1", lambda mx: mx.metric.F1(), _binary),
    ("perplexity", lambda mx: mx.metric.Perplexity(None), _tokens),
    ("perplexity_ignore", lambda mx: mx.metric.Perplexity(ignore_label=0),
     lambda: _tokens(ignore=0)),
    ("mae", lambda mx: mx.metric.MAE(), _regression),
    ("mse", lambda mx: mx.metric.MSE(), _regression),
    ("rmse", lambda mx: mx.metric.RMSE(), _regression),
    ("ce", lambda mx: mx.metric.CrossEntropy(), _classification),
    ("create_ce", lambda mx: mx.metric.create("ce"), _classification),
    ("loss", lambda mx: mx.metric.Loss(), _regression),
    ("custom", lambda mx: mx.metric.CustomMetric(
        lambda l, p: float(np.abs(l.reshape(-1, 1) - p).sum()),
        name="l1"), _regression),
    ("np", lambda mx: mx.metric.np(
        lambda l, p: (float((p.argmax(1) == l).sum()), l.size)),
     _classification),
], ids=lambda v: v if isinstance(v, str) else "")
def test_metric_matches_jax(name, make, batches):
    _feed(make(jmx), make(tmx), batches())


def test_composite_metric_and_create_list():
    want = jmx.metric.create(["acc", "ce"])
    got = tmx.metric.create(["acc", "ce"])
    assert isinstance(got, tmx.metric.CompositeEvalMetric)
    for labels, preds in _classification():
        want.update([jmx.nd.array(x) for x in labels],
                    [jmx.nd.array(x) for x in preds])
        got.update([tmx.nd.array(x, ctx=tmx.cpu()) for x in labels],
                   [tmx.nd.array(x, ctx=tmx.cpu()) for x in preds])
    (gn, gv), (wn, wv) = got.get(), want.get()
    assert gn == wn
    np.testing.assert_allclose(gv, wv, rtol=1e-6)
    got.reset()
    assert np.isnan(got.get()[1]).all()
    with pytest.raises(ValueError, match="Cannot find metric"):
        tmx.metric.create("no_such_metric")


def test_metric_drops_non_finite_batches():
    m = tmx.metric.MAE()
    m.update([tmx.nd.array([1.0], ctx=tmx.cpu())],
             [tmx.nd.array([[np.nan]], ctx=tmx.cpu())])
    m.update([tmx.nd.array([1.0], ctx=tmx.cpu())],
             [tmx.nd.array([[3.0]], ctx=tmx.cpu())])
    assert m.num_nonfinite == 1 and m.get()[1] == 2.0


# ---------------------------------------------------------------- callbacks
def _param(mx, nbatch, metric):
    return mx.model.BatchEndParam(epoch=1, nbatch=nbatch,
                                  eval_metric=metric, locals=None)


def test_speedometer_logs_the_jax_line(caplog):
    lines = {}
    for mx in (jmx, tmx):
        kw = {"ctx": tmx.cpu()} if mx is tmx else {}
        metric = mx.metric.Accuracy()
        metric.update([mx.nd.array(np.zeros(4, np.float32), **kw)],
                      [mx.nd.array(np.eye(4, dtype=np.float32), **kw)])
        speed = mx.callback.Speedometer(batch_size=4, frequent=2)
        caplog.clear()
        with caplog.at_level(logging.INFO):
            for n in range(5):
                speed(_param(mx, n, metric))
        lines[mx.__name__] = [r.getMessage() for r in caplog.records]
    form = re.compile(r"^Epoch\[1\] Batch \[(\d+)\]\tSpeed: [0-9.]+ "
                      r"samples/sec\tTrain-accuracy=[0-9.na]+$")
    assert [form.match(s).group(1) for s in lines["mxnet_tpu_torch"]] == \
        [form.match(s).group(1) for s in lines["mxnet_tpu"]] == ["2", "4"]


def test_log_train_metric_and_progress_bar(caplog):
    metric = tmx.metric.Accuracy()
    metric.update([tmx.nd.array(np.zeros(2, np.float32), ctx=tmx.cpu())],
                  [tmx.nd.array(np.eye(2, dtype=np.float32), ctx=tmx.cpu())])
    with caplog.at_level(logging.INFO):
        tmx.callback.log_train_metric(2)(_param(tmx, 2, metric))
        tmx.callback.ProgressBar(4, length=8)(_param(tmx, 2, metric))
        tmx.callback.LogValidationMetricsCallback()(_param(tmx, 2, metric))
    msgs = [r.getMessage() for r in caplog.records]
    assert msgs[0] == "Iter[1] Batch[2] Train-accuracy=0.500000"
    assert msgs[1].startswith("[====----] 50%")
    assert msgs[2] == "Epoch[1] Validation-accuracy=0.500000"


def test_do_checkpoint_writes_files_jax_loads(tmp_path):
    """do_checkpoint every 2 epochs: files only after epochs 2 and 4, in the
    JAX package's format."""
    net = tmx.sym.FullyConnected(tmx.sym.Variable("data"), num_hidden=3,
                                 name="fc")
    rng = np.random.RandomState(0)
    arg = {"fc_weight": tmx.nd.array(rng.randn(3, 4), ctx=tmx.cpu()),
           "fc_bias": tmx.nd.array(rng.randn(3), ctx=tmx.cpu())}
    prefix = str(tmp_path / "ck")
    cb = tmx.callback.do_checkpoint(prefix, period=2)
    for epoch in range(4):
        cb(epoch, net, arg, {})
    assert tmx.model.find_checkpoints(prefix) == [2, 4]
    assert not os.path.exists("%s-0001.params" % prefix)
    sym, args, aux = jmx.model.load_checkpoint(prefix, 4)
    assert sym.list_arguments() == net.list_arguments()
    for k, v in arg.items():
        np.testing.assert_array_equal(np.asarray(args[k].asnumpy()),
                                      v.asnumpy())
    assert not [f for f in os.listdir(tmp_path) if ".tmp" in f]
