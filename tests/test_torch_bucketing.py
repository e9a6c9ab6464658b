"""The port's BucketingModule against the JAX package's, on the CPU.

* A trajectory of ``STEPS`` batches across four buckets of the
  lstm_bucketing LM (2 LSTMCell layers at a narrow width, dropout 0),
  from the JAX module's Xavier weights carried over by
  ``convert.from_jax_module``, on the same batches (``BucketSentenceIter``
  under the same ``random``/``np.random`` seeds): under SGD with momentum
  every parameter after every step within rtol 1e-5 and 1e-6 of its
  array's largest entry, and each batch's perplexity within rtol 1e-5 (f32
  on the CPU; the sums group differently).  Under Adam the perplexity
  within rtol 1e-5 and every parameter within 1e-4 of its array's largest
  entry: Adam's step lr g / (|g| + eps) moves an entry whose gradient is
  as small as the rounding of its sum by a share of lr that the rounding
  decides (measured: 2.4e-6 of the largest entry after 8 steps).
* The acid properties of ``tests/test_bucketing_acid.py`` on the port:
  one bind a bucket, none after the first epoch nor on
  ``switch_bucket``; every bucket on the same parameter, gradient and
  optimizer-state tensors; the perplexity below 1.35 on the successor
  corpus after six epochs (Adam, lr 0.02).
* ``save_checkpoint`` of the port's module loads in the JAX package, and
  chip_smoke's bucketing phases and ``tools/lstm_bucketing`` run on the CPU
  at a tiny size.
"""
import json
import os
import random
import sys

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import convert
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.tools import lstm_bucketing

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUCKETS = [4, 8, 12, 16]
VOCAB = 24
STEPS = 8


@pytest.fixture(autouse=True)
def _no_pending_data_state():
    """Each package's ``load_checkpoint`` stashes data state for its next
    fit in the process, and a fit tracks its iterator for the next
    checkpoint; clear both after each test."""
    yield
    jmx.io_resume.clear_pending()
    tmx.io_resume.clear_pending()
    tmx.io_resume.track(None)


def _corpus(n=400, seed=0):
    """test_bucketing_acid's successor sentences: tok[i+1] = 3 tok[i] + 1
    mod VOCAB, lengths filling all four buckets."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        ln = int(rng.choice([3, 4, 6, 8, 10, 12, 14, 16]))
        t = int(rng.randint(1, VOCAB))
        s = [t]
        for _ in range(ln - 1):
            t = (3 * t + 1) % VOCAB
            s.append(max(t, 1))
        out.append(s)
    return out


def _iter(mx, batch=16, n=400, seed=5):
    random.seed(seed)
    np.random.seed(seed)
    return mx.rnn.BucketSentenceIter(_corpus(n), batch_size=batch,
                                     buckets=list(BUCKETS), invalid_label=0)


def _module(mx, it, hidden=16, embed=12, layers=2):
    return mx.mod.BucketingModule(
        lstm_bucketing.lstm_sym_gen(VOCAB, hidden, embed, layers, mx=mx),
        default_bucket_key=it.default_bucket_key, context=mx.cpu())


def _trajectory(mx, it, mod, optimizer, params):
    mod.bind(it.provide_data, it.provide_label)
    if mx is jmx:
        np.random.seed(7)
        mod.init_params(initializer=jmx.init.Xavier(factor_type="in",
                                                    magnitude=2.34))
    else:
        mod.init_params(arg_params=params[0], aux_params=params[1])
    mod.init_optimizer(optimizer=optimizer, optimizer_params=dict(
        {"learning_rate": 0.05, "wd": 1e-5},
        **({"momentum": 0.9} if optimizer == "sgd" else {})))
    steps, buckets = [], []
    for batch in it:
        if len(steps) == STEPS:
            break
        mod.forward_backward(batch)
        mod.update()
        m = mx.metric.Perplexity(0)
        m.update(batch.label, mod.get_outputs())
        buckets.append(batch.bucket_key)
        steps.append((m.get()[1], {k: v.asnumpy().copy() for k, v in
                                   mod.get_params()[0].items()}))
    return steps, buckets


@pytest.mark.parametrize("optimizer", ["sgd", "adam"])
def test_trajectory_matches_jax(optimizer):
    jit, tit = _iter(jmx), _iter(tmx)
    jmod = _module(jmx, jit)
    jsteps, jbuckets = _trajectory(jmx, jit, jmod, optimizer, None)
    # the port starts from the JAX module's initial weights
    jinit = _module(jmx, _iter(jmx))
    jinit.bind(jit.provide_data, jit.provide_label)
    np.random.seed(7)
    jinit.init_params(initializer=jmx.init.Xavier(factor_type="in",
                                                  magnitude=2.34))
    params = convert.from_jax_module(jinit)
    assert all(v.context == tmx.cpu() for v in params[0].values())
    tmod = _module(tmx, tit)
    tsteps, tbuckets = _trajectory(tmx, tit, tmod, optimizer, params)
    assert tbuckets == jbuckets and len(set(tbuckets)) >= 3, tbuckets
    assert len(tsteps) == STEPS
    atol = 1e-6 if optimizer == "sgd" else 1e-4
    for i, ((tp, tw), (jp, jw)) in enumerate(zip(tsteps, jsteps)):
        np.testing.assert_allclose(tp, jp, rtol=1e-5)
        assert sorted(tw) == sorted(jw)
        for k, w in jw.items():
            np.testing.assert_allclose(
                tw[k], w, 1e-5, atol * np.abs(w).max(),
                err_msg="%s after step %d (bucket %d)" % (k, i, tbuckets[i]))


def test_bucketing_acid():
    """test_bucketing_acid.py on the port: binds bounded by the bucket
    count, shared parameters and optimizer state, switch_bucket without a
    bind, and the successor rule learned."""
    it = tmx.rnn.BucketSentenceIter(_corpus(), batch_size=16,
                                    buckets=list(BUCKETS), invalid_label=0)
    mod = _module(tmx, it, hidden=48, embed=32, layers=1)
    binds = tmx.Executor.binds
    mod.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
    mod.init_params(initializer=tmx.initializer.Xavier(rng=0))
    mod.init_optimizer(optimizer="adam",
                       optimizer_params={"learning_rate": 0.02})
    metric = tmx.metric.Perplexity(ignore_label=0)
    ppls = []
    for epoch in range(6):
        it.reset()
        metric.reset()
        for batch in it:
            mod.forward_backward(batch)
            mod.update()
            mod.update_metric(metric, batch.label)
        ppls.append(metric.get()[1])
        if epoch == 0:
            after_first = tmx.Executor.binds - binds
    assert sorted(mod._buckets) == BUCKETS
    assert after_first == tmx.Executor.binds - binds == len(BUCKETS)
    assert ppls[-1] < 1.35, ppls
    assert ppls[-1] < ppls[0] / 3, ppls

    lstm_bucketing_sharing = lstm_bucketing.sharing(mod)
    assert all(lstm_bucketing_sharing.values()), lstm_bucketing_sharing
    default = mod._buckets[it.default_bucket_key]
    # one optimizer state a parameter, the same tensors for every bucket
    states = default._updater.states
    assert sorted(states) == list(range(len(default._param_names)))
    for m in mod._buckets.values():
        assert m._param_names == default._param_names
        assert m._updater.states is states
    ref_args, _ = mod.get_params()
    for m in mod._buckets.values():
        assert m.get_params()[0] is ref_args

    before = tmx.Executor.binds
    for want in (4, 16, 8):
        mod.switch_bucket(want, None, None)
        assert mod._curr_bucket_key == want
    it.reset()
    batch = next(iter(it))
    mod.forward_backward(batch)
    mod.update()
    assert tmx.Executor.binds == before


def test_shared_module_takes_the_shared_parameter_order():
    """A Module bound with ``shared_module=`` lists the shared parameters in
    that module's order, so each position of the borrowed Updater holds
    one parameter's momentum: a step of ``b + a`` after a step of ``a + b``
    equals two steps of ``a + b`` (the same function; float rounding
    only, rtol 1e-6)."""
    rng = np.random.RandomState(0)
    x = rng.randn(4, 5).astype(np.float32)
    y = rng.randint(0, 3, 4).astype(np.float32)
    data = tmx.sym.Variable("data")
    label = tmx.sym.Variable("softmax_label")
    a = tmx.sym.FullyConnected(data, num_hidden=3, name="fa")
    b = tmx.sym.FullyConnected(tmx.sym.Activation(data, act_type="tanh"),
                               num_hidden=3, name="fb")
    shapes = ([("data", x.shape)], [("softmax_label", y.shape)])
    batch = tmx.io.DataBatch([tmx.nd.array(x, ctx=tmx.cpu())],
                             [tmx.nd.array(y, ctx=tmx.cpu())])

    def module(out, shared=None):
        m = tmx.mod.Module(tmx.sym.SoftmaxOutput(out, label, name="softmax"),
                           context=tmx.cpu())
        m.bind(*shapes, shared_module=shared)
        if shared is None:
            m.init_params(initializer=tmx.init.Xavier(rng=0))
            m.init_optimizer(optimizer="sgd", optimizer_params={
                "learning_rate": 0.1, "momentum": 0.9})
        return m

    first = module(a + b)
    swapped = module(b + a, shared=first)
    assert swapped._param_names == first._param_names
    assert tmx.mod.Module(b + a, context=tmx.cpu())._param_names != \
        first._param_names
    ref = module(a + b)
    for m in (first, swapped, ref, ref):
        m.forward_backward(batch)
        m.update()
    got, want = first.get_params()[0], ref.get_params()[0]
    for k in want:
        np.testing.assert_allclose(got[k].asnumpy(), want[k].asnumpy(),
                                   rtol=1e-6, atol=1e-7)


def test_bucketing_surface(tmp_path):
    it = _iter(tmx)
    mod = _module(tmx, it)
    assert mod.data_names == ("data",)
    assert mod.output_names == ["softmax_output"]
    with pytest.raises(MXNetError, match="shared_module"):
        mod.bind(it.provide_data, it.provide_label, shared_module=mod)
    mod.bind(it.provide_data, it.provide_label)
    mod.init_params(initializer=tmx.init.Xavier(rng=0))
    mod.init_optimizer(optimizer="sgd", optimizer_params={
        "learning_rate": 0.1, "momentum": 0.9})
    batch = next(b for b in it if b.bucket_key == 8)
    mod.prepare(batch)            # binds bucket 8, stays on the default
    assert sorted(mod._buckets) == [8, 16] and mod._curr_bucket_key == 16
    mod.forward_backward(batch)
    mod.update()
    assert mod._curr_bucket_key == 8
    assert mod.data_shapes[0].shape == (16, 8)
    assert mod.output_shapes == [("softmax_output", (128, VOCAB))]
    mon = tmx.Monitor(1, pattern=".*softmax.*")
    mod.install_monitor(mon)
    mon.tic()
    mod.forward(batch, is_train=False)
    names = [n for _s, n, _v in mon.toc()]
    assert names == ["softmax_output"]

    prefix = str(tmp_path / "lm")
    mod.save_checkpoint(prefix, 2, save_optimizer_states=True)
    sym, args, _aux = jmx.model.load_checkpoint(prefix, 2)
    # the default bucket's graph, read the same by both packages
    assert sym.tojson() == tmx.sym.load(prefix + "-symbol.json").tojson()
    assert sym.list_arguments() == mod._buckets[16].symbol.list_arguments()
    mine = mod.get_params()[0]
    assert sorted(args) == sorted(mine)
    for k, v in mine.items():
        np.testing.assert_array_equal(args[k].asnumpy(), v.asnumpy())
    assert os.path.exists(prefix + "-0002.states")
    # and back: the saved parameters set a new port module
    fresh = _module(tmx, it)
    fresh.bind(it.provide_data, it.provide_label, for_training=False)
    fresh.set_params(convert.from_jax_params(
        {("arg:" + k): v for k, v in args.items()}, tmx.cpu()), {})
    for k, v in fresh.get_params()[0].items():
        np.testing.assert_array_equal(v.asnumpy(), mine[k].asnumpy())


def test_chip_smoke_bucketing_phases_at_a_tiny_size():
    """chip_smoke's bucketing_train, bucketing_check, rnn_ops and
    module_api on the CPU at vocabulary 200 and width 8 to 16 (SGD at lr
    0.5, where 0.01 moves a model this narrow too little): 6 binds in the
    first epoch, one storage for all buckets, a falling perplexity,
    no kernel launched; the Module step on the CPU equals itself; the RNN
    op within its bound of the unfused cells; the hinge loss falls and the
    Monitor sees every op output of one bucket."""
    sys.path.insert(0, ROOT)
    import chip_smoke
    cfg = {"vocab": 200, "num_hidden": 16, "num_embed": 16,
           "num_layers": 2, "batch_size": 8}
    out = chip_smoke.bucketing_train_phase(tmx.cpu(), cfg, sentences=240,
                                           val_sentences=40, epochs=2,
                                           bound=200.0, lr=0.5)
    assert out["binds"] == 6 and out["epochs"][0]["binds_so_far"] == 6
    assert all(out["sharing"].values())
    assert out["train_perplexity"][1] < out["train_perplexity"][0] < 200
    assert out["validation_perplexity"][1] < 200
    assert set(out["kernel_launches"].values()) == {0}
    assert sorted(out["bucket_step_ms"]) == sorted(
        str(b) for b in lstm_bucketing.BUCKETS)
    small = dict(cfg, num_hidden=8, num_embed=8, batch_size=4)
    chk = chip_smoke.bucketing_check_phase(tmx.cpu(), small, steps=3)
    assert chk["max_rel_update_diff"] == 0.0 and len(set(chk["buckets"])) \
        == 3
    rnn = chip_smoke.rnn_ops_phase(tmx.cpu(), small, seq=10, small_seq=5,
                                   repeats=1)
    assert len(rnn["cases"]) == 1 + len(chip_smoke.RNN_SMALL_CASES)
    api = chip_smoke.module_api_phase(tmx.cpu(), n=400, batch=50,
                                      monitor_cfg=small)
    assert api["batches"] == 8
    mon = api["monitor"]
    assert mon["stats"] == mon["op_outputs"] == 2 * mon["bucket"] + 2


def test_lstm_bucketing_tool(capsys):
    lstm_bucketing.main(["--cpu", "--num-hidden", "8", "--num-embed", "8",
                         "--vocab", "50", "--sentences", "160",
                         "--batch-size", "8", "--num-epochs", "2",
                         "--num-layers", "1"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["corpus"] == "successor chain" and out["binds"] == 6
    assert len(out["epochs"]) == 2 and out["context"] == "cpu(0)"
    assert out["config"]["vocab"] == 50 and out["params"] > 0
    with pytest.raises(SystemExit, match="parsed by the example"):
        lstm_bucketing.main(["--cpu", "--stack-rnn"])
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="no CUDA device"):
            lstm_bucketing.main([])
    sents = lstm_bucketing.successor_corpus(50, 10000, 100, seed=3)
    assert sents == lstm_bucketing.successor_corpus(50, 10000, 100, seed=3)
    tokens = {t for s in sents for t in s}
    assert len(tokens) <= 100 and min(tokens) >= 1 and max(tokens) < 10000
    assert all(2 <= len(s) <= 60 for s in sents)
