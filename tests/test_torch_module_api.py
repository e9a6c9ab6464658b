"""The port's SequentialModule, PythonLossModule and Monitor against the
JAX package's, on the CPU.

* ``examples/module_api/sequential_module.py``'s chain (an MLP trunk
  without labels auto-wired into a classifier head) and
  ``examples/module_api/python_loss.py``'s (an MLP chained into a
  ``PythonLossModule`` whose gradient is the numpy hinge subgradient), fit
  for one epoch of ``BATCHES`` batches in both packages from the same
  Xavier draws (numpy's global generator for JAX, a ``RandomState`` of the
  same seed for the port, one stream across the chained modules) on the
  same batches: after every batch every parameter within rtol 1e-5 and
  1e-5 of its array's largest entry, and the metric within rtol 1e-5 (f32
  on the CPU; SGD with momentum; the sums group differently).
* ``Monitor``: the port's ``(step, name, value)`` triples against the JAX
  ``Monitor(eager=True)``'s on the same module and batch: the same steps
  and names in the same order, each value within rtol 1e-5; ``pattern``,
  ``sort``, ``interval`` and a custom ``stat_func`` alike; ``fit(monitor=)``
  logs them.
"""
import logging
import os
import sys

import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu import models as jmodels

import mxnet_tpu_torch as tmx

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BATCHES = 5
BATCH = 40


def _data(n=BATCHES * BATCH, dim=20, seed=0):
    protos = np.random.RandomState(42).rand(10, dim).astype("f")
    rng = np.random.RandomState(seed)
    y = rng.randint(0, 10, n)
    x = protos[y] + 0.25 * rng.randn(n, dim).astype("f")
    return x.astype("f"), y.astype("f")


def _chain(mx, kind):
    ctx = mx.cpu()
    data = mx.sym.Variable("data")
    fc1 = mx.sym.FullyConnected(data, name="fc1", num_hidden=16)
    act1 = mx.sym.Activation(fc1, name="relu1", act_type="relu")
    seq = mx.mod.SequentialModule()
    if kind == "sequential":
        trunk = mx.mod.Module(act1, label_names=[], context=ctx)
        data = mx.sym.Variable("data")
        fc2 = mx.sym.FullyConnected(data, name="fc2", num_hidden=12)
        act2 = mx.sym.Activation(fc2, name="tanh2", act_type="tanh")
        fc3 = mx.sym.FullyConnected(act2, name="fc3", num_hidden=10)
        head = mx.mod.Module(mx.sym.SoftmaxOutput(fc3, name="softmax"),
                             context=ctx)
        return seq.add(trunk).add(head, take_labels=True, auto_wiring=True)
    fc2 = mx.sym.FullyConnected(act1, name="fc2", num_hidden=10)
    mlp = mx.mod.Module(fc2, label_names=[], context=ctx)
    loss = mx.mod.PythonLossModule(grad_func=mc_hinge_grad)
    return seq.add(mlp).add(loss, take_labels=True, auto_wiring=True)


def mc_hinge_grad(scores, labels):
    """python_loss.py's Crammer-Singer multiclass hinge subgradient."""
    scores = scores.asnumpy()
    labels = labels.asnumpy().astype(np.int64)
    n, _ = scores.shape
    grad = np.zeros_like(scores)
    for i in range(n):
        score = 1 + scores[i] - scores[i, labels[i]]
        score[labels[i]] = 0
        ind_pred = score.argmax()
        grad[i, labels[i]] -= 1
        grad[i, ind_pred] += 1
    return grad / n


def _fit(mx, kind, seed=3):
    x, y = _data()
    np.random.seed(1)
    it = mx.io.NDArrayIter(x, y, BATCH, shuffle=True)
    if mx is jmx:
        np.random.seed(seed)
        init = jmx.init.Xavier()
    else:
        init = tmx.init.Xavier(rng=seed)
    seq = _chain(mx, kind)
    trace = []

    def record(param):
        args, _aux = seq.get_params()
        trace.append((param.eval_metric.get()[1],
                      {k: v.asnumpy().copy() for k, v in args.items()}))
    seq.fit(it, num_epoch=1, initializer=init, optimizer="sgd",
            optimizer_params={"learning_rate": 0.1, "momentum": 0.9},
            batch_end_callback=record)
    return seq, it, trace


@pytest.mark.parametrize("kind", ["sequential", "python_loss"])
def test_chains_match_jax(kind):
    _jseq, _jit, jtrace = _fit(jmx, kind)
    tseq, tit, ttrace = _fit(tmx, kind)
    assert len(ttrace) == len(jtrace) == BATCHES
    for step, ((tm, tw), (jm, jw)) in enumerate(zip(ttrace, jtrace)):
        np.testing.assert_allclose(tm, jm, rtol=1e-5)
        assert sorted(tw) == sorted(jw)
        for k, w in jw.items():
            np.testing.assert_allclose(tw[k], w, 1e-5,
                                       1e-5 * np.abs(w).max(),
                                       err_msg="%s after %d" % (k, step))
    assert tseq.output_shapes[0][1] == (BATCH, 10)
    if kind == "sequential":
        score = tseq.score(tit, tmx.metric.Accuracy())[0][1]
        assert 0.0 <= score <= 1.0


def test_python_loss_module_surface():
    loss = tmx.mod.PythonLossModule()
    loss.bind([("data", (4, 3))], [("softmax_label", (4,))])
    assert loss.output_shapes == [("pyloss_output", (4, 3))]
    scores = tmx.nd.array(np.ones((4, 3)), ctx=tmx.cpu())
    batch = tmx.io.DataBatch([scores], [tmx.nd.zeros(4, ctx=tmx.cpu())])
    loss.forward(batch, is_train=True)
    assert loss.get_outputs()[0] is scores
    with pytest.raises(NotImplementedError):
        loss.backward()            # no grad_func
    with pytest.raises(NotImplementedError):
        loss.install_monitor(None)
    assert loss.get_params() == ({}, {})
    head = tmx.mod.PythonLossModule(grad_func=lambda s, l: np.zeros((4, 3)))
    head.bind([("data", (4, 3))], [("softmax_label", (4,))])
    head.forward(batch, is_train=True)
    head.backward()
    grad = head.get_input_grads()[0]
    assert grad.context == scores.context and grad.shape == (4, 3)


def _monitored(mx, jnet, **kw):
    """A Module of the MLP ``jnet`` (the JAX package's graph, loaded by the
    port from its JSON) on the CPU with a Monitor installed, the triples of
    one training forward (and of the next tic, for the interval)."""
    x, y = _data(n=BATCH)
    net = jnet if mx is jmx else tmx.sym.load_json(jnet.tojson())
    it = mx.io.NDArrayIter(x, y, BATCH)
    mod = mx.mod.Module(net, context=mx.cpu())
    mod.bind(it.provide_data, it.provide_label)
    if mx is jmx:
        np.random.seed(0)
        mod.init_params(initializer=jmx.init.Xavier())
    else:
        mod.init_params(initializer=tmx.init.Xavier(rng=0))
    if mx is jmx:
        kw = dict(kw, eager=True)
    mon = mx.Monitor(**kw)
    mod.install_monitor(mon)
    batch = next(it)
    out = []
    for _ in range(2):
        mon.tic()
        mod.forward(batch, is_train=True)
        out.append(mon.toc())
    return out


@pytest.mark.parametrize("kw", [
    {"interval": 1},
    {"interval": 2, "pattern": "fc.*", "sort": True},
    {"interval": 1, "pattern": ".*relu.*",
     "stat_func": lambda x: x.asnumpy().max()}])
def test_monitor_triples_match_jax(kw):
    jnet = jmodels.get_model("mlp", num_classes=10)
    jout, tout = _monitored(jmx, jnet, **kw), _monitored(tmx, jnet, **kw)
    assert len(tout) == len(jout) == 2
    for t, j in zip(tout, jout):
        assert [(s, n) for s, n, _v in t] == [(s, n) for s, n, _v in j]
        for (_s, _n, tv), (_t, _m, jv) in zip(t, j):
            assert tv.endswith("\t") and jv.endswith("\t")
            np.testing.assert_allclose(float(tv), float(jv), rtol=1e-5)
    assert tout[0]
    if kw["interval"] == 2:
        assert tout[1] == []       # the second tic is not an active one


def test_fit_with_a_monitor_logs_its_statistics(caplog):
    x, y = _data(n=2 * BATCH)
    net = tmx.sym.load_json(jmodels.get_model(
        "mlp", num_classes=10).tojson())
    mod = tmx.mod.Module(net, context=tmx.cpu())
    mon = tmx.mon.Monitor(2, pattern=".*softmax.*")
    with caplog.at_level(logging.INFO):
        mod.fit(tmx.io.NDArrayIter(x, y, BATCH), num_epoch=1,
                initializer=tmx.init.Xavier(rng=0), monitor=mon)
    lines = [r.getMessage() for r in caplog.records
             if r.getMessage().startswith("Batch:")]
    assert len(lines) == 1 and "softmax_output" in lines[0]
    assert mon.exes == [mod._exec_group.execs[0]]


def test_chip_smoke_hinge_gradient_equals_the_examples_loop():
    """chip_smoke computes python_loss.py's gradient over the batch at
    once; the example's loop is the reference, bit for bit."""
    sys.path.insert(0, ROOT)
    import chip_smoke
    rng = np.random.RandomState(0)
    scores = tmx.nd.array(rng.normal(0, 1, (64, 10)), ctx=tmx.cpu())
    labels = tmx.nd.array(rng.randint(0, 10, 64), ctx=tmx.cpu())
    np.testing.assert_array_equal(chip_smoke.mc_hinge_grad(scores, labels),
                                  mc_hinge_grad(scores, labels))
