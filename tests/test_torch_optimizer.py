"""The port's optimizers, update rules, initializers and lr schedulers
against the JAX package's, on the same numpy arrays and seeds."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu.parallel.trainer import _make_update_rule as jax_rule
from mxnet_tpu import initializer as jinit, lr_scheduler as jlrs

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import initializer as tinit, lr_scheduler as tlrs
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.parallel.trainer import _make_update_rule as port_rule

RULES = [
    ("sgd", {"momentum": 0.0}),
    ("sgd", {"momentum": 0.9, "clip_gradient": 0.5}),
    ("ccsgd", {"momentum": 0.9}),
    ("nag", {"momentum": 0.9}),
    ("adam", {}),
    ("adam", {"beta1": 0.8, "clip_gradient": 1.0}),
    ("adagrad", {}),
    ("rmsprop", {"gamma1": 0.95}),
    ("adadelta", {"clip_gradient": 0.3}),
]


@pytest.mark.parametrize("name,kw", RULES,
                         ids=["%s-%d" % (r[0], i) for i, r in
                              enumerate(RULES)])
def test_update_rule_matches_jax_over_three_steps(name, kw):
    rng = np.random.RandomState(0)
    w0 = rng.normal(0, 1, (5, 7)).astype(np.float32)
    grads = [rng.normal(0, 1, (5, 7)).astype(np.float32) for _ in range(3)]
    lr, wd = 0.05, 0.01
    n_j, rule_j = jax_rule(jmx.optimizer.create(name, **kw))
    n_p, rule_p = port_rule(tmx.optimizer.create(name, **kw))
    assert n_j == n_p
    wj, sj = jnp.asarray(w0), [jnp.zeros_like(w0) for _ in range(n_j)]
    wp = torch.from_numpy(w0.copy())
    sp = [torch.zeros_like(wp) for _ in range(n_p)]
    for t, g in enumerate(grads, start=1):
        wj, sj = rule_j(wj, jnp.asarray(g), sj, lr, wd, float(t))
        rule_p(wp, torch.from_numpy(g), sp, lr, wd, float(t))
        np.testing.assert_allclose(wp.numpy(), np.asarray(wj), 1e-6, 1e-6)
        for a, b in zip(sp, sj):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), 1e-6, 1e-6)


def test_centered_rmsprop_has_no_rule_in_either_package():
    for mod, rule in ((jmx, jax_rule), (tmx, port_rule)):
        with pytest.raises(Exception):
            rule(mod.optimizer.create("rmsprop", centered=True))


def test_create_registry_and_defaults():
    for name in ("sgd", "ccsgd", "nag", "adam", "adagrad", "rmsprop",
                 "adadelta"):
        jo, po = jmx.optimizer.create(name), tmx.optimizer.create(name)
        assert type(po).__name__ == type(jo).__name__
        assert po.lr == jo.lr and po.rescale_grad == jo.rescale_grad
    with pytest.raises(ValueError):
        tmx.optimizer.create("no-such-optimizer")
    opt = tmx.optimizer.create("sgd", rescale_grad=0.25, learning_rate=0.3,
                               momentum=0.5)
    assert (opt.rescale_grad, opt.lr, opt.momentum) == (0.25, 0.3, 0.5)


def test_wd_mult_defaults_and_symbol_multipliers():
    names = {0: "fc_weight", 1: "fc_bias", 2: "ln_gamma", 3: "ln_beta",
             4: "tok_embed_weight"}
    jo = jmx.optimizer.create("sgd", param_idx2name=names, wd=0.1)
    po = tmx.optimizer.create("sgd", param_idx2name=names, wd=0.1)
    assert po.wd_mult == jo.wd_mult == {"fc_bias": 0.0, "ln_beta": 0.0}
    # per-variable multipliers from the symbol's attributes
    w = tmx.sym.Variable("fc_weight", __lr_mult__=2.0, __wd_mult__=0.5)
    net = tmx.sym.FullyConnected(tmx.sym.Variable("data"), weight=w,
                                 num_hidden=3, name="fc")
    po = tmx.optimizer.create("sgd", param_idx2name=names, sym=net)
    assert po.lr_mult == {"fc_weight": 2.0}
    assert po.wd_mult["fc_weight"] == 0.5 and po.wd_mult["fc_bias"] == 0.0


def test_imperative_update_is_not_yet_ported():
    """The imperative update of the Module path: one SGD step through the
    Updater is w - lr * g, and the base class has no rule of its own."""
    opt = tmx.optimizer.create("sgd", learning_rate=0.5)
    upd = tmx.optimizer.get_updater(opt)
    w = tmx.nd.array(np.ones(3, np.float32), ctx=tmx.cpu())
    upd(0, tmx.nd.array(np.full(3, 2.0, np.float32), ctx=tmx.cpu()), w)
    np.testing.assert_array_equal(w.asnumpy(), np.zeros(3, np.float32))
    with pytest.raises(NotImplementedError):
        tmx.optimizer.Optimizer().update(0, w, w, None)


@pytest.mark.parametrize("make", [
    lambda m, **kw: m.Xavier(rnd_type="gaussian", factor_type="in",
                             magnitude=2, **kw),
    lambda m, **kw: m.Xavier(**kw),
    lambda m, **kw: m.Xavier(rnd_type="uniform", factor_type="out", **kw),
    lambda m, **kw: m.Normal(0.02, **kw),
    lambda m, **kw: m.Uniform(0.1, **kw),
], ids=["xavier-gauss-in", "xavier-default", "xavier-out", "normal",
        "uniform"])
def test_initializer_draws_equal_jax_for_one_seed(make):
    """The port draws from its own RandomState; the JAX initializer from
    numpy's global one.  Seeded alike and called in the same order, the
    draws are equal."""
    names = [("fc_weight", (6, 4)), ("fc_bias", (6,)),
             ("conv_weight", (3, 2, 3, 3)), ("ln_gamma", (4,)),
             ("ln_beta", (4,)), ("out_weight", (5, 6))]
    np.random.seed(7)
    ji = make(jinit)
    want = {}
    for n, s in names:
        arr = jmx.nd.zeros(s)
        ji(jinit.InitDesc(n), arr)
        want[n] = arr.asnumpy()
    pi = make(tinit, rng=np.random.RandomState(7))
    for n, s in names:
        arr = np.zeros(s, np.float32)
        pi(tinit.InitDesc(n), arr)
        np.testing.assert_array_equal(arr, want[n])


def test_initializer_seed_and_dispatch():
    a, b = np.zeros((3, 4), np.float32), np.zeros((3, 4), np.float32)
    tinit.Normal(1.0, rng=3)("w_weight", a)
    tinit.Normal(1.0, rng=np.random.RandomState(3))("w_weight", b)
    np.testing.assert_array_equal(a, b)
    for name, value in (("x_bias", 0.0), ("x_gamma", 1.0), ("x_beta", 0.0),
                        ("bn_moving_var", 1.0), ("bn_moving_mean", 0.0)):
        arr = np.full((2,), 5.0, np.float32)
        tinit.Zero()(name, arr)
        assert (arr == value).all(), name
    with pytest.raises(MXNetError):
        tinit.Zero()("mystery", np.zeros(2, np.float32))


@pytest.mark.parametrize("make", [
    lambda m: m.FactorScheduler(step=3, factor=0.5),
    lambda m: m.MultiFactorScheduler(step=[2, 5, 9], factor=0.1),
    lambda m: m.PolyScheduler(max_update=12, power=2.0),
], ids=["factor", "multifactor", "poly"])
def test_lr_scheduler_matches_jax(make):
    js, ps = make(jlrs), make(tlrs)
    js.base_lr = ps.base_lr = 0.2
    for n in range(1, 15):
        assert ps(n) == pytest.approx(js(n), rel=1e-12), n
