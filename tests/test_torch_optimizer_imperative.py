"""The port's imperative optimizer against the JAX package's, on the CPU.

The five update ops (``nd.sgd_update`` ... ``nd.rmspropalex_update``) and
five ``Updater`` steps of every optimizer the port registers, with
``rescale_grad``, ``wd``, ``clip_gradient`` and lr/wd mults, from the same
numpy-made weights and gradients: weights and states agree within rtol
1e-6 (atol 1e-7), the same f32 arithmetic in another library.  ``.states``
files written by either package load in the other.  The imperative SGD
and Adam steps equal ``ShardedTrainer``'s fused rules
(``parallel.trainer._make_update_rule``) on the same values.
"""
import pickle

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.parallel.trainer import _make_update_rule

RTOL, ATOL = 1e-6, 1e-7
SHAPE = (5, 7)


def _arrays(n, seed=0, positive=()):
    rng = np.random.RandomState(seed)
    out = [rng.randn(*SHAPE).astype(np.float32) for _ in range(n)]
    for i in positive:
        out[i] = np.abs(out[i]) + 0.1
    return out


def _j(x):
    return jmx.nd.array(x)


def _t(x):
    return tmx.nd.array(x, ctx=tmx.cpu())


def _close(got, want, msg=""):
    np.testing.assert_allclose(got.asnumpy(), np.asarray(want.asnumpy()),
                               RTOL, ATOL, err_msg=msg)


@pytest.mark.parametrize("name,n_states,positive,kw", [
    ("sgd_update", 0, (), dict(lr=0.1, wd=0.01, rescale_grad=0.5,
                               clip_gradient=0.4)),
    ("sgd_mom_update", 1, (), dict(lr=0.1, momentum=0.9, wd=0.01,
                                   rescale_grad=0.5)),
    ("adam_update", 2, (3,), dict(lr=0.01, beta1=0.8, beta2=0.99,
                                  epsilon=1e-6, wd=0.02, rescale_grad=2.0,
                                  clip_gradient=1.0)),
    ("rmsprop_update", 1, (2,), dict(lr=0.01, gamma1=0.9, epsilon=1e-6,
                                     rescale_grad=0.5, clip_weights=0.8)),
    ("rmspropalex_update", 3, (2,), dict(lr=0.01, gamma1=0.9, gamma2=0.8,
                                         epsilon=1e-6, wd=0.01,
                                         clip_gradient=0.5)),
])
def test_update_op_matches_jax(name, n_states, positive, kw):
    """weight, grad and states from a seed; the op writes the weight
    (out=weight) and the states in place, as the JAX op's wrapper does."""
    vals = _arrays(2 + n_states, positive=positive)
    if name == "rmspropalex_update":
        vals[3] = vals[3] * 0.1      # g small against n: n - g^2 > 0
    jv, tv = [_j(v) for v in vals], [_t(v) for v in vals]
    getattr(jmx.nd, name)(*jv, out=jv[0], **kw)
    getattr(tmx.nd, name)(*tv, out=tv[0], **kw)
    for i, (g, w) in enumerate(zip(tv, jv)):
        if i != 1:
            _close(g, w, "%s input %d" % (name, i))


OPTIMIZERS = [
    ("sgd", dict(learning_rate=0.1)),
    ("sgd", dict(learning_rate=0.1, momentum=0.9)),
    ("ccsgd", dict(learning_rate=0.1, momentum=0.9)),
    ("nag", dict(learning_rate=0.1, momentum=0.9)),
    ("nag", dict(learning_rate=0.1)),
    ("adam", dict(learning_rate=0.01)),
    ("adagrad", dict(learning_rate=0.1)),
    ("rmsprop", dict(learning_rate=0.01)),
    ("rmsprop", dict(learning_rate=0.01, centered=True, clip_weights=2.0)),
    ("adadelta", dict()),
]


def _optimizer(mx, name, kw, sym=None):
    return mx.optimizer.create(
        name, rescale_grad=0.5, wd=0.01, clip_gradient=1.5,
        param_idx2name={0: "fc_weight", 1: "fc_bias"}, sym=sym, **kw)


def _steps(mx, name, kw, wrap, steps=5):
    """Five Updater steps of two parameters (a weight with an lr mult, a
    bias, which takes no weight decay) from a seed."""
    opt = _optimizer(mx, name, kw)
    opt.set_lr_mult({"fc_weight": 0.5})
    opt.set_wd_mult({"fc_bias": 2.0})
    upd = mx.optimizer.get_updater(opt)
    w0, w1 = _arrays(2, seed=1)
    weights = [wrap(w0), wrap(w1)]
    for step in range(steps):
        grads = _arrays(2, seed=10 + step)
        for i, w in enumerate(weights):
            upd(i, wrap(grads[i]), w)
    return weights, upd, opt


@pytest.mark.parametrize("name,kw", OPTIMIZERS,
                         ids=lambda v: v if isinstance(v, str) else
                         "-".join("%s=%s" % i for i in sorted(v.items())))
def test_five_updater_steps_match_jax(name, kw):
    jw, jupd, jopt = _steps(jmx, name, kw, _j)
    tw, tupd, topt = _steps(tmx, name, kw, _t)
    for i in range(2):
        _close(tw[i], jw[i], "weight %d" % i)
    jstates = pickle.loads(jupd.get_states())
    tstates = pickle.loads(tupd.get_states())
    assert sorted(tstates) == sorted(jstates)
    for k in jstates:
        want = jstates[k] if isinstance(jstates[k], tuple) \
            else (jstates[k],)
        got = tstates[k] if isinstance(tstates[k], tuple) \
            else (tstates[k],)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            if w is None:
                assert g is None
            else:
                np.testing.assert_allclose(g, w, RTOL, ATOL)
    assert topt.num_update == jopt.num_update == 5


@pytest.mark.parametrize("name,kw", [("sgd", dict(momentum=0.9)),
                                     ("adam", dict()),
                                     ("rmsprop", dict(centered=True))])
def test_states_files_load_in_either_package(tmp_path, name, kw):
    """Updater.get_states pickles {index: numpy | tuple | None}; a file
    written by either package is read by the other, and the next update
    from it is the same."""
    jw, jupd, _ = _steps(jmx, name, kw, _j, steps=2)
    tw, tupd, _ = _steps(tmx, name, kw, _t, steps=2)
    for src, dst_mx, wrap, weights in ((jupd, tmx, _t, tw),
                                       (tupd, jmx, _j, jw)):
        path = tmp_path / ("%s-%s.states" % (name, dst_mx.__name__))
        path.write_bytes(src.get_states())
        upd = dst_mx.optimizer.get_updater(
            _optimizer(dst_mx, name, kw))
        upd.set_states(path.read_bytes())
        for k, v in pickle.loads(src.get_states()).items():
            got = pickle.loads(upd.get_states())[k]
            for g, w in zip(got if isinstance(got, tuple) else (got,),
                            v if isinstance(v, tuple) else (v,)):
                np.testing.assert_array_equal(g, w)
        # one more update from the loaded states on the dst side
        grad = wrap(_arrays(1, seed=99)[0])
        upd(0, grad, weights[0])


def _trainer_step(opt, w, g, t):
    n_slots, rule = _make_update_rule(opt)
    slots = [torch.zeros_like(w) for _ in range(n_slots)]
    for step in range(t):
        rule(w, g.float() * opt.rescale_grad, slots,
             opt.lr * opt.lr_mult.get("fc_weight", 1.0),
             opt.wd_mult.get("fc_weight", 1.0) * opt.wd, step + 1)
    return w


@pytest.mark.parametrize("name,kw", [("sgd", dict(momentum=0.0)),
                                     ("sgd", dict(momentum=0.9)),
                                     ("adam", dict())])
def test_imperative_step_equals_the_trainers_rule(name, kw):
    """Three steps on one weight: Optimizer.update through the Updater and
    the trainer's fused rule give the same weight (both f32, the same
    arithmetic)."""
    w0, g0 = _arrays(2, seed=3)
    opt = tmx.optimizer.create(name, learning_rate=0.05, wd=0.01,
                               rescale_grad=0.25,
                               param_idx2name={0: "fc_weight"}, **kw)
    upd = tmx.optimizer.get_updater(opt)
    w = _t(w0)
    for _ in range(3):
        upd(0, _t(g0), w)
    fused = _trainer_step(
        tmx.optimizer.create(name, learning_rate=0.05, wd=0.01,
                             rescale_grad=0.25,
                             param_idx2name={0: "fc_weight"}, **kw),
        torch.from_numpy(w0.copy()), torch.from_numpy(g0), 3)
    np.testing.assert_allclose(w.asnumpy(), fused.numpy(), 1e-6, 1e-7)


def test_symbol_lr_mult_and_default_wd():
    """lr_mult from the symbol's ``__lr_mult__``; wd off for biases."""
    data = tmx.sym.Variable("data")
    w = tmx.sym.Variable("fc_weight", __lr_mult__=0.1)
    net = tmx.sym.FullyConnected(data, weight=w, num_hidden=2, name="fc")
    opt = tmx.optimizer.create("sgd", sym=net, wd=0.1,
                               param_idx2name={0: "fc_weight",
                                               1: "fc_bias"})
    assert opt.lr_mult == {"fc_weight": 0.1}
    assert opt._get_wd(1) == 0.0 and opt._get_wd(0) == 0.1
