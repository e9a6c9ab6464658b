"""The port's Module API against the JAX package's, on the CPU.

``Module.fit`` of the MLP of ``examples/image_classification/train_mnist.py``
on its synthetic data (SGD with momentum, Accuracy) and of the mini GPT
through ``train_lm.train()``'s call pattern (``markov_batches`` at vocab
64, Xavier, Adam at 3e-3, Perplexity; dropout 0, since the packages draw
from other generators): one graph JSON, the same batches (numpy's global
generator seeded before each iterator) and the same Xavier draws (numpy's
global generator for JAX, a ``RandomState`` of the same seed for the port).
The MLP (SGD): after each of 5 batches the metric and every parameter
agree within rtol 1e-5 (params with an atol of 1e-5 of the array's largest
entry, for sums in other orders).  The GPT (Adam): the first batch's
perplexity within rtol 1e-5.  Later ones depend on how Adam carries
rounding forward.  Its step is lr g / (|g| + eps), so an entry whose
gradient is as small as the rounding of its sum moves by a share of lr
that the rounding decides, and a pre-activation within rounding of 0 can
take another ReLU mask in each package (chip_smoke's train check meets the
same).  Over eight data seeds (markov_batches' shuffle) the port and JAX
read: perplexity up to 1.14e-5 apart, the relative norm of each weight
matrix's difference up to 3.9e-4 (1e-5 or less at six seeds), the
biases, betas and gammas up to 0.011 lr a step apart.  The bounds: 5e-5,
1e-3 and 0.05 lr a step.  The key third of each qkv bias has a true
gradient of 0 (a key bias shifts a query's scores by one constant, which
softmax removes), so both packages update it from rounding noise alone:
those entries are held to 2 lr a step.
Then ``score``/``predict``, checkpoints and ``.states`` written by either
package and loaded by the other (the same score, the same states),
``FeedForward``, and ``install_monitor``, which hooks a ``Monitor`` into the
bound executor.
"""
import logging
import os
import pickle
import sys

import numpy as np
import pytest

import torch_threads  # noqa: F401  (xdist workers share the cores)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "examples", "transformer"))

import train_lm  # noqa: E402
import mxnet_tpu as jmx  # noqa: E402
from mxnet_tpu import models as jmodels  # noqa: E402

import mxnet_tpu_torch as tmx  # noqa: E402
from mxnet_tpu_torch.base import MXNetError  # noqa: E402

BATCHES = 5


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


def _mnist(n=BATCHES * 32, batch=32):
    """train_mnist's synthetic stand-in: class-separated gaussians."""
    rng = np.random.RandomState(0)
    y = rng.randint(0, 10, n).astype(np.float32)
    x = rng.rand(n, 784).astype(np.float32) * 0.1
    for i in range(10):
        x[y == i, i * 78:(i + 1) * 78] += 0.8
    return x, y, batch


class _Trace:
    """A batch-end callback keeping every parameter and the metric."""

    def __init__(self, mod):
        self.mod, self.params, self.metrics = mod, [], []

    def __call__(self, param):
        args, _aux = self.mod.get_params()
        self.params.append({k: v.asnumpy().copy() for k, v in args.items()})
        self.metrics.append(param.eval_metric.get()[1])


def _fit(mx, net, x, y, batch, optimizer, opt_params, metric, init_seed,
         speedometer=False):
    ctx = mx.cpu()
    np.random.seed(3)
    it = mx.io.NDArrayIter(x, y, batch, shuffle=True)
    if mx is tmx:
        init = tmx.init.Xavier(rng=init_seed)
    else:
        np.random.seed(init_seed)
        init = jmx.init.Xavier()
    mod = mx.mod.Module(net, context=ctx)
    trace = _Trace(mod)
    callbacks = [trace] + ([mx.callback.Speedometer(batch, 2)]
                           if speedometer else [])
    mod.fit(it, num_epoch=1, initializer=init, optimizer=optimizer,
            optimizer_params=opt_params, eval_metric=metric(mx),
            batch_end_callback=callbacks)
    return mod, it, trace


def _compare(jtrace, ttrace, adam_lr=None, d_model=None):
    """Metric and parameters after every batch: entry by entry, or under
    Adam (``adam_lr``) by the bounds of the module docstring."""
    assert len(ttrace.params) == len(jtrace.params) == BATCHES
    np.testing.assert_allclose(ttrace.metrics[0], jtrace.metrics[0],
                               rtol=1e-5)
    np.testing.assert_allclose(ttrace.metrics, jtrace.metrics,
                               rtol=1e-5 if adam_lr is None else 5e-5)
    for step, (got, want) in enumerate(zip(ttrace.params, jtrace.params)):
        for k, w in want.items():
            g = got[k]
            msg = "%s after batch %d" % (k, step + 1)
            if adam_lr is None:
                np.testing.assert_allclose(g, w, 1e-5,
                                           1e-5 * np.abs(w).max(),
                                           err_msg=msg)
                continue
            if k.endswith("_qkv_bias"):
                d = d_model
                assert np.abs(g[d:2 * d] - w[d:2 * d]).max() \
                    <= 2 * adam_lr * (step + 1), msg
                g, w = np.delete(g, np.s_[d:2 * d]), \
                    np.delete(w, np.s_[d:2 * d])
            if k.endswith("_weight"):
                assert np.linalg.norm(g - w) <= 1e-3 * np.linalg.norm(w), msg
            else:
                assert np.abs(g - w).max() <= 0.05 * adam_lr * (step + 1), \
                    msg


@pytest.fixture(scope="module")
def mlp_pair():
    jnet = jmodels.get_model("mlp", num_classes=10)
    tnet = tmx.sym.load_json(jnet.tojson())
    x, y, batch = _mnist()
    kw = dict(optimizer="sgd",
              opt_params={"learning_rate": 0.1, "momentum": 0.9},
              metric=lambda mx: mx.metric.Accuracy(), init_seed=4)
    return (_fit(jmx, jnet, x, y, batch, **kw),
            _fit(tmx, tnet, x, y, batch, **kw), (x, y, batch))


def test_fit_mlp_matches_jax(mlp_pair):
    (_jm, _ji, jtrace), (_tm, _ti, ttrace), _data = mlp_pair
    _compare(jtrace, ttrace)


def test_score_and_predict_match_jax(mlp_pair):
    (jm, ji, _j), (tm, ti, _t), _data = mlp_pair
    want = jm.score(ji, "acc")
    got = tm.score(ti, "acc")
    assert got == want
    jp = jm.predict(ji)
    tp = tm.predict(ti)
    assert tp.context == tmx.cpu() and tp.shape == tuple(jp.shape)
    np.testing.assert_allclose(tp.asnumpy(), np.asarray(jp.asnumpy()),
                               1e-5, 1e-6)
    batches = list(tm.iter_predict(ti))
    assert len(batches) == BATCHES and batches[0][1] == 0


def test_fit_gpt_through_train_lm_pattern_matches_jax():
    """train()'s call: Module(net).fit(it, Xavier(), 'adam' at 3e-3,
    Perplexity(None), Speedometer) then score, at vocab 64, seq 64,
    d_model 64, 4 heads, 2 layers, batch 16, dropout 0."""
    cfg = dict(vocab_size=64, seq_len=64, d_model=64, n_heads=4, n_layers=2,
               dropout=0.0)
    jnet = train_lm.gpt_symbol(**cfg)
    tnet = tmx.sym.load_json(jnet.tojson())
    np.random.seed(0)            # markov_batches shuffles from it
    jit, _trans = train_lm.markov_batches(BATCHES * 16 * 64, 64, 64, 16)
    x, y = jit.data[0][1], jit.label[0][1]
    lr = 3e-3
    kw = dict(optimizer="adam", opt_params={"learning_rate": lr},
              metric=lambda mx: mx.metric.Perplexity(None), init_seed=5,
              speedometer=True)
    jm, ji, jtrace = _fit(jmx, jnet, x, y, 16, **kw)
    tm, ti, ttrace = _fit(tmx, tnet, x, y, 16, **kw)
    _compare(jtrace, ttrace, adam_lr=lr, d_model=64)
    assert ttrace.metrics[-1] < ttrace.metrics[0]
    want = jm.score(ji, jmx.metric.Perplexity(None))[0][1]
    got = tm.score(ti, tmx.metric.Perplexity(None))[0][1]
    np.testing.assert_allclose(got, want, rtol=1e-5)


def _score(mx, prefix, epoch, x, y, batch, states=False):
    mod = mx.mod.Module.load(prefix, epoch, load_optimizer_states=states,
                             context=mx.cpu())
    it = mx.io.NDArrayIter(x, y, batch)
    mod.bind(data_shapes=it.provide_data, label_shapes=it.provide_label,
             for_training=states)
    if states:
        mod.init_optimizer(optimizer="sgd",
                           optimizer_params={"learning_rate": 0.1,
                                             "momentum": 0.9})
    return mod.score(it, "ce")[0][1], mod


def _states(mod):
    return pickle.loads(mod._updater.get_states())


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoints_load_in_the_other_package(tmp_path, mlp_pair, writer):
    """save_checkpoint(prefix, 1, save_optimizer_states=True) by one
    package, Module.load(prefix, 1, load_optimizer_states=True) by the
    other: the same cross-entropy score and the same momentum states."""
    (jm, _ji, _j), (tm, _ti, _t), (x, y, batch) = mlp_pair
    src, src_mx, dst_mx = (jm, jmx, tmx) if writer == "jax" \
        else (tm, tmx, jmx)
    prefix = str(tmp_path / "mlp")
    src.save_checkpoint(prefix, 1, save_optimizer_states=True)
    assert os.path.exists(prefix + "-0001.states")
    want, _m = _score(src_mx, prefix, 1, x, y, batch)
    got, mod = _score(dst_mx, prefix, 1, x, y, batch, states=True)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    saved = _states(src)
    loaded = _states(mod)
    assert sorted(loaded) == sorted(saved)
    for k in saved:
        np.testing.assert_array_equal(loaded[k], saved[k])


def test_checkpoint_is_written_whole(tmp_path, mlp_pair):
    """Files are written under a temporary name and renamed: none is left
    behind, and the epochs are found."""
    _j, (tm, _ti, _t), _data = mlp_pair
    prefix = str(tmp_path / "m")
    tm.save_checkpoint(prefix, 3)
    tm.save_checkpoint(prefix, 12)
    assert tmx.model.find_checkpoints(prefix) == [3, 12]
    assert not [f for f in os.listdir(tmp_path) if ".tmp" in f]
    with pytest.raises(MXNetError, match="missing for epoch 4"):
        tmx.model.load_checkpoint(prefix, 4)


def test_feedforward_fit_and_predict_match_jax():
    jnet = jmodels.get_model("mlp", num_classes=10)
    tnet = tmx.sym.load_json(jnet.tojson())
    x, y, _batch = _mnist(n=96)
    out = {}
    for mx, net in ((jmx, jnet), (tmx, tnet)):
        if mx is jmx:
            np.random.seed(6)
            init = jmx.init.Xavier()
        else:
            init = tmx.init.Xavier(rng=6)
        model = mx.model.FeedForward(net, ctx=mx.cpu(), num_epoch=2,
                                     optimizer="sgd", initializer=init,
                                     numpy_batch_size=32,
                                     learning_rate=0.1)
        model.fit(x, y)
        out[mx.__name__] = (model.predict(x), model.score(
            mx.io.NDArrayIter(x, y, 32)))
    (tp, ts), (jp, js) = out["mxnet_tpu_torch"], out["mxnet_tpu"]
    np.testing.assert_allclose(tp, jp, 1e-5, 1e-6)
    assert ts == js


def test_module_surface(mlp_pair):
    """Shapes, outputs, get_input_grads, reshape, install_monitor, several
    contexts and a dist store outside a job."""
    _j, (tm, ti, _t), (x, y, batch) = mlp_pair
    assert tm.data_shapes[0].shape == (batch, 784)
    assert tm.output_shapes == [("softmax_output", (batch, 10))]
    mon = tmx.Monitor(1)
    tm.install_monitor(mon)
    assert mon.exes == [tm._exec_group.execs[0]]
    tm._exec_group.execs[0].set_monitor_callback(None)
    mod = tmx.mod.Module(tm.symbol, context=tmx.cpu())
    mod.bind(data_shapes=ti.provide_data, label_shapes=ti.provide_label,
             inputs_need_grad=True)
    mod.init_params(arg_params=tm.get_params()[0])
    ti.reset()
    mod.forward_backward(next(ti))
    assert mod.get_input_grads()[0].shape == (batch, 784)
    assert np.abs(mod.get_input_grads()[0].asnumpy()).max() > 0
    assert mod.get_outputs()[0].shape == (batch, 10)
    mod.forward(next(tmx.io.NDArrayIter(x[:batch], y[:batch], batch)),
                is_train=False)
    full = mod.get_outputs()[0].asnumpy()
    # a reshape keeps the parameters: the first 8 rows give the same
    # outputs at batch 8
    mod.reshape(data_shapes=[("data", (8, 784))],
                label_shapes=[("softmax_label", (8,))])
    mod.forward(next(tmx.io.NDArrayIter(x[:8], y[:8], 8)), is_train=False)
    np.testing.assert_allclose(mod.get_outputs()[0].asnumpy(), full[:8],
                               1e-6, 1e-7)
    # several contexts split the batch (their training is held against
    # JAX in test_torch_dist_kvstore.py), and a dist store outside a job
    # is a store of one worker, as in JAX
    two = tmx.mod.Module(tm.symbol, context=[tmx.cpu(0), tmx.cpu(1)])
    two.bind(data_shapes=ti.provide_data, label_shapes=ti.provide_label)
    assert [sl.stop - sl.start for sl in two._exec_group.slices] == \
        [batch // 2, batch - batch // 2]
    kv = tmx.kv.create("dist_sync")
    assert (kv.type, kv.rank, kv.num_workers) == ("dist_sync", 0, 1)


def test_fit_logs_epoch_lines(caplog, mlp_pair):
    _j, _t, (x, y, batch) = mlp_pair
    net = tmx.sym.load_json(jmodels.get_model("mlp", num_classes=10)
                            .tojson())
    it = tmx.io.NDArrayIter(x, y, batch)
    mod = tmx.mod.Module(net, context=tmx.cpu())
    with caplog.at_level(logging.INFO):
        mod.fit(it, num_epoch=1, optimizer_params={"learning_rate": 0.1},
                eval_data=it, initializer=tmx.init.Xavier(rng=0))
    msgs = [r.getMessage() for r in caplog.records]
    assert any(m.startswith("Epoch[0] Train-accuracy=") for m in msgs)
    assert any(m.startswith("Epoch[0] Time cost=") for m in msgs)
    assert any(m.startswith("Epoch[0] Validation-accuracy=") for m in msgs)


def test_module_fit_permutation_chain():
    """Each next token is perm[token]: one permutation for every sequence,
    labels the tokens shifted by one, all from the seed, every token among
    ``support`` of the vocabulary and none its own successor."""
    from mxnet_tpu_torch.tools.module_fit import permutation_chain
    x, y = permutation_chain(6, 40, 64, seed=1, support=8)
    x2, y2 = permutation_chain(6, 40, 64, seed=1, support=8)
    assert np.array_equal(x, x2) and np.array_equal(y, y2)
    assert x.shape == y.shape == (6, 40) and x.dtype == np.float32
    np.testing.assert_array_equal(x[:, 1:], y[:, :-1])
    assert len(np.unique(np.concatenate([x, y]))) <= 8
    step = {}
    for a, b in zip(x.reshape(-1), y.reshape(-1)):
        assert step.setdefault(a, b) == b
    assert len(step) == len(set(step.values()))


def test_module_fit_trainer_route_follows_the_module():
    """``tools.module_fit``'s two routes at vocab 64, seq 128, d_model 32,
    dropout 0.1, on a chain of 16 tokens: the fused ShardedTrainer step
    from the weights Module.init_params draws, with the same Dropout draws,
    gives the Module's perplexity at each of 8 batches (rtol 1e-5: float
    sums in other orders), and both fall below the 16 of the unigram."""
    from mxnet_tpu_torch.tools import module_fit
    cfg = {"vocab": 64, "seq": 128, "d_model": 32, "heads": 2, "layers": 2}
    mod = module_fit.fit(tmx.cpu(), cfg, 4, 8, 3e-3, 16)
    trainer = module_fit.trainer_fit(tmx.cpu(), cfg, 4, 8, 3e-3, 16)
    np.testing.assert_allclose(trainer["batch_perplexity"],
                               mod["batch_perplexity"], rtol=1e-5)
    assert mod["batch_perplexity"][-1] < 16
    assert len(trainer["batch_ms"]) == 7


def test_chip_smoke_module_phases_at_a_tiny_size():
    """chip_smoke's module_train and module_check on the CPU at vocab 64,
    seq 128, d_model 32: the perplexity falls over 8 batches, below the
    64 of the chain's unigram at the end and in the score, no kernel
    launches on the CPU, the reloaded checkpoint scores the same, and the
    Module's SGD step on the CPU equals itself."""
    sys.path.insert(0, ROOT)
    import chip_smoke
    cfg = {"vocab": 64, "seq": 128, "d_model": 32, "heads": 2, "layers": 2}
    out = chip_smoke.module_train_phase(tmx.cpu(), cfg, batch=4, batches=8)
    assert len(out["batch_perplexity"]) == 8 == len(out["batch_ms"]) + 1
    assert out["batch_perplexity"][-1] < out["batch_perplexity"][0]
    assert set(out["fit_launches"].values()) == {0}
    assert out["checkpoint"]["rel_diff"] <= 1e-6
    assert len(out["speedometer"]) == 3
    assert out["chain_support"] == chip_smoke.CHAIN_SUPPORT == 64
    assert out["tail_perplexity"] < 64 and out["score"] < 64
    chk = chip_smoke.module_check_phase(tmx.cpu(), cfg)
    assert chk["max_rel_update_diff"] == 0.0 and chk["params"] > 0


def test_module_fit_tool_needs_a_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from mxnet_tpu_torch.tools import module_fit
    with pytest.raises(SystemExit, match="no CUDA device"):
        module_fit.main(["--lr", "1e-3"])
    a = module_fit.parse_args(["--lr", "3e-3,1e-4", "--support", "256"])
    assert (a.lr, a.support, a.batches, a.trainer) == ("3e-3,1e-4", "256",
                                                       20, False)
